"""The port's Adam, optimizer dispatch and gradient clamp against the JAX
package's optax chains on the CPU.

Adam: four updates with weight decay 5e-4 and a warm-up LR that changes
every step, over one parameter of each of the flagship's groups (stem and
res2 frozen; res3-5 weights and biases; ASPP and classifier weights and
biases), each named as the port names it and as the JAX package does.
Parameters within rtol 1e-6 / atol 1e-7 (float32: the same operations in
the same order, up to a fused multiply-add); the frozen ones bit-equal to
their start.
"""

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.train import optim as joptim
from spml_tpu_torch.config import load_config
from spml_tpu_torch.train import optim

# port name -> (JAX path, shape)
PARAMS = {
    "embedding.resnet_backbone.conv1.conv1.0.weight": (
        ("embedding", "resnet_backbone", "stem", "conv1_1", "conv",
         "kernel"), (3, 2)),
    "embedding.resnet_backbone.res2.0.conv1.weight": (
        ("embedding", "resnet_backbone", "res2", "block0", "conv1", "conv",
         "kernel"), (4,)),
    "embedding.resnet_backbone.res3.0.conv1.weight": (
        ("embedding", "resnet_backbone", "res3", "block0", "conv1", "conv",
         "kernel"), (3, 4)),
    "embedding.resnet_backbone.res4.0.bn1.bias": (
        ("embedding", "resnet_backbone", "res4", "block0", "conv1", "bn",
         "bias"), (5,)),
    "embedding.resnet_backbone.res5.0.bn2.weight": (
        ("embedding", "resnet_backbone", "res5", "block0", "conv2", "bn",
         "scale"), (5,)),
    "embedding.aspp.aspp_1.0.weight": (
        ("embedding", "aspp", "aspp_1", "kernel"), (2, 3)),
    "embedding.aspp.aspp_1.0.bias": (
        ("embedding", "aspp", "aspp_1", "bias"), (3,)),
    "prediction.semantic_classifier.0.weight": (
        ("prediction", "conv1", "kernel"), (2, 2)),
    "prediction.semantic_classifier.4.bias": (
        ("prediction", "conv2", "bias"), (4,)),
}
OVERRIDES = {"train": {"optimizer": "adam", "warmup_iteration": 3,
                       "max_iteration": 10}}


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = v
    return out


def test_groups_agree_with_jax_labels():
    for name, (path, _) in PARAMS.items():
        assert optim.label_param(name) == joptim.label_param(path), name
    labels = {optim.label_param(n) for n in PARAMS}
    assert labels == set(optim.GROUP_MULT)


def test_adam_matches_optax_chain():
    rng = np.random.RandomState(0)
    init = {n: rng.randn(*s).astype(np.float32)
            for n, (_, s) in PARAMS.items()}
    grads = [{n: (rng.randn(*s) * 10.0 ** rng.randint(-3, 1)).astype(
        np.float32) for n, (_, s) in PARAMS.items()} for _ in range(4)]
    jcfg = jload_config(overrides=OVERRIDES)
    cfg = load_config(overrides=OVERRIDES)
    sched = optim.make_schedule(cfg.train)

    jparams = _nest({PARAMS[n][0]: jnp.asarray(v) for n, v in init.items()})
    tx = joptim.build_optimizer(jparams, jcfg.train)
    opt = tx.init(jparams)
    params = {n: torch.from_numpy(v.copy()).requires_grad_(True)
              for n, v in init.items()}
    mu, nu, count = {}, {}, 0
    for i, g in enumerate(grads):
        upd, opt = tx.update(
            _nest({PARAMS[n][0]: jnp.asarray(v) for n, v in g.items()}),
            opt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n])
        count = optim.adam_step(list(params.items()), mu, nu, count,
                                sched(i), cfg.train.weight_decay)
    assert count == 4
    for n, (path, _) in PARAMS.items():
        want = np.asarray(_get(jparams, path))
        got = params[n].detach().numpy()
        if optim.label_param(n) == optim.FROZEN:
            np.testing.assert_array_equal(got, init[n], err_msg=n)
            assert n not in mu
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=n)


def _get(tree, path):
    for part in path:
        tree = tree[part]
    return tree


@pytest.mark.parametrize("kind", ["sgd", "adam", "rmsprop"])
def test_build_optimizer_dispatch(kind):
    """sgd -> the momentum buffers move, adam -> the moments and the count;
    any other name raises ValueError, as the JAX package's dispatch."""
    over = {"train": {"optimizer": kind}}
    cfg, jcfg = load_config(overrides=over), jload_config(overrides=over)
    if kind == "rmsprop":
        with pytest.raises(ValueError, match="rmsprop"):
            optim.build_optimizer(cfg.train)
        with pytest.raises(ValueError, match="rmsprop"):
            joptim.build_optimizer({"w": jnp.zeros(2)}, jcfg.train)
        return
    from spml_tpu_torch.train.state import TrainState
    p = torch.ones(3, requires_grad=True)
    p.grad = torch.full((3,), 0.5)
    state = TrainState(step=0, emb_model=None, cls_model=None, momentum={},
                       memory=None, generator=torch.Generator())
    state = optim.build_optimizer(cfg.train)([("aspp.w", p)], state, 0.1)
    if kind == "sgd":
        assert set(state.momentum) == {"aspp.w"} and not state.adam_mu
    else:
        assert set(state.adam_mu) == set(state.adam_nu) == {"aspp.w"}
        assert state.adam_count == 1 and not state.momentum
    assert not torch.equal(p.detach(), torch.ones(3))


def test_clip_grads_matches_jax():
    rng = np.random.RandomState(1)
    grads = [rng.randn(4, 3).astype(np.float32) * 3, rng.randn(5).astype(
        np.float32)]
    got = optim.clip_grads([torch.from_numpy(g) for g in grads], 1.5)
    want = joptim.clip_grads([jnp.asarray(g) for g in grads], 1.5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert max(float(a.abs().max()) for a in got) == 1.5
