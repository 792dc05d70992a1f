"""The port's train step against the JAX train step on the CPU: two steps
from the same weights and batch, so that step 2 sees the memory bank and
the momentum buffers. Plus the optimizer pieces on their own.

The JAX side runs tpu.use_fused_loss=True with the joint Pallas kernel in
interpret mode (the mock.patch pattern of tests/test_pallas_loss.py,
traced under jax.jit inside the patch); the port runs the plain version
of its kernels, which is what a CPU tensor gets. The classifier's dropout
is 0 on both sides: the two RNG streams cannot match.

Tolerances: losses and metrics rtol 1e-4 (the jitted and eager JAX steps
already differ by ~6e-6 at step 2). The two steps' parameter and BN
statistic updates (value after minus value before) within
1e-2 * max|update|: on these same checks the jitted and the eager JAX
steps differ by up to 7.2e-3 (a BN scale whose gradient is a sum that
mostly cancels), and the port by the same amounts. Memory-bank
prototypes (unit rows) atol 3e-4: jitted and eager JAX differ there by
1.0e-4, the port by the same. Labels, batch indices, tags and validity
exactly equal.
"""

import math
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.models.embeddings import ClassifierHead as JHead
from spml_tpu.ops.pallas import segsort_loss as jfused
from spml_tpu.train import optim as joptim
from spml_tpu.train import state as jstate_lib
from spml_tpu.train import step as jstep
from spml_tpu_torch.config import load_config
from spml_tpu_torch.train import optim, state as state_lib, step as tstep
from spml_tpu_torch.utils import from_jax

UPDATE_RTOL = 1e-2

OVERRIDES = {
    "network": {"backbone_types": "panoptic_deeplab_10",
                "embedding_dim": 8, "kmeans_num_clusters": [2, 2],
                "kmeans_iterations": 2},
    "dataset": {"num_classes": 4},
    "train": {"batch_size": 2, "crop_size": [32, 32],
              "memory_bank_size": 1, "max_iteration": 100,
              "warmup_iteration": 10},
    "tpu": {"segment_capacity": 32, "compute_dtype": "float32",
            "use_fused_loss": True},
}

CHECKED_PARAMS = [
    "embedding.aspp.aspp_1.0.weight", "embedding.aspp.aspp_3.0.bias",
    "embedding.resnet_backbone.res3.0.conv2.weight",
    "embedding.resnet_backbone.res4.0.bn1.weight",
    "embedding.resnet_backbone.res5.0.downsample.0.weight",
    "embedding.resnet_backbone.conv1.conv1.0.weight",  # frozen
    "prediction.semantic_classifier.0.weight",
    "prediction.semantic_classifier.4.bias",
]
CHECKED_STATS = [
    "embedding.resnet_backbone.conv1.bn1.running_mean",  # frozen stage
    "embedding.resnet_backbone.res2.0.bn3.running_var",
    "embedding.resnet_backbone.res5.0.bn2.running_mean",
    "prediction.semantic_classifier.1.running_var",
]


def _batch():
    rng = np.random.RandomState(3)
    return {
        "image": rng.randn(2, 32, 32, 3).astype(np.float32),
        "semantic_label": rng.randint(0, 5, (2, 32, 32)).astype(np.int32),
        "instance_label": rng.randint(0, 3, (2, 32, 32)).astype(np.int32),
        "semantic_tag": (rng.rand(2, 256) > 0.6).astype(np.int32),
    }


def _state_dicts(params, batch_stats):
    p = jax.tree.map(np.asarray, params)
    s = jax.tree.map(np.asarray, batch_stats)
    out = {}
    for k, v in from_jax.embedding_state_dict(
            p["embedding"], s["embedding"]).items():
        out["embedding." + k] = v
    for k, v in from_jax.classifier_state_dict(
            p["prediction"], s["prediction"]).items():
        out["prediction." + k] = v
    return out


def _port_state_dict(state):
    out = {"embedding." + k: v
           for k, v in state.emb_model.state_dict().items()}
    out.update({"prediction." + k: v
                for k, v in state.cls_model.state_dict().items()})
    return out


def _close(got, want, rel_atol):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=rel_atol * max(np.abs(want).max(), 1e-6))


def test_two_train_steps_match_jax():
    nb = _batch()
    jcfg = jload_config(overrides=OVERRIDES)
    jst = jstep.init_state(jcfg, jax.random.PRNGKey(0),
                           jnp.zeros((2, 32, 32, 3)))
    emb_def, _ = jstep.build_models(jcfg)
    head = JHead(num_classes=4, hidden_dim=16, dropout_rate=0.0,
                 dtype=jnp.float32)

    cfg = load_config(overrides=OVERRIDES)
    st = tstep.init_state(cfg, 0, torch.zeros(2, 32, 32, 3), device="cpu")
    sd = _state_dicts(jst.params, jst.batch_stats)
    st.emb_model.load_state_dict(
        {k[len("embedding."):]: v for k, v in sd.items()
         if k.startswith("embedding.")}, strict=True)
    st.cls_model.load_state_dict(
        {k[len("prediction."):]: v for k, v in sd.items()
         if k.startswith("prediction.")}, strict=True)
    st.cls_model.semantic_classifier[3].p = 0.0
    step = tstep.make_train_step(cfg)

    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    orig = jfused.fused_joint_losses
    with mock.patch.object(
            jfused, "fused_joint_losses",
            lambda *a, **k: orig(*a, **{**k, "interpret": True})):
        jfn = jax.jit(jstep.make_train_step(jcfg, emb_def, head))
        for i in range(2):
            jst, jm = jfn(jst, jbatch)
            st, tm = step(st, tbatch)
            assert set(tm) == set(jm)
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"step {i} {k}")
    assert st.step == int(jst.step) == 2

    want = _state_dicts(jst.params, jst.batch_stats)
    got = _port_state_dict(st)
    for k in CHECKED_PARAMS + CHECKED_STATS:
        _close(got[k].detach().numpy() - sd[k].numpy(),
               want[k].numpy() - sd[k].numpy(), rel_atol=UPDATE_RTOL)
    # the frozen stem never moves
    np.testing.assert_array_equal(
        got["embedding.resnet_backbone.conv1.conv1.0.weight"].numpy(),
        sd["embedding.resnet_backbone.conv1.conv1.0.weight"].numpy())

    jmem, tmem = jst.memory, st.memory
    for name in ("prototype", "prototype_with_loc"):
        np.testing.assert_allclose(getattr(tmem, name).numpy(),
                                   np.asarray(getattr(jmem, name)),
                                   rtol=0, atol=3e-4, err_msg=name)
    for name in ("semantic_label", "instance_label", "batch_index", "tag",
                 "valid"):
        np.testing.assert_array_equal(getattr(tmem, name).numpy(),
                                      np.asarray(getattr(jmem, name)),
                                      err_msg=name)


@pytest.mark.parametrize("policy", ["poly", "step"])
def test_schedules_match_jax(policy):
    cfg = load_config(overrides={"train": {
        "lr_policy": policy, "warmup_iteration": 10, "max_iteration": 100,
        "decay_iterations": [20, 50]}})
    jcfg = jload_config(overrides={"train": {
        "lr_policy": policy, "warmup_iteration": 10, "max_iteration": 100,
        "decay_iterations": [20, 50]}})
    ours, theirs = optim.make_schedule(cfg.train), \
        joptim.make_schedule(jcfg.train)
    for s in (0, 1, 5, 9, 10, 11, 19, 20, 49, 50, 99):
        np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=1e-6)


def test_poly_schedule_past_max_iteration_is_nan_as_jax():
    """At step max_iteration + 1 the poly schedule is a float nan, as the
    JAX schedule's float32 power of a negative base; at max_iteration it
    is 0.0 in both."""
    over = {"train": {"lr_policy": "poly", "warmup_iteration": 10,
                      "max_iteration": 100}}
    ours = optim.make_schedule(load_config(overrides=over).train)
    theirs = joptim.make_schedule(jload_config(overrides=over).train)
    assert ours(100) == float(theirs(100)) == 0.0
    got, want = ours(101), float(theirs(101))
    assert isinstance(got, float) and math.isnan(got) and math.isnan(want)


def test_sgd_matches_optax_chain():
    """Three updates of four parameter groups (plus a frozen one) with a
    changing LR: the hand-written SGD == the JAX package's optax chain."""
    rng = np.random.RandomState(4)
    names = {"resnet_backbone.res3.0.conv1.weight": (3, 2),
             "resnet_backbone.res3.0.bn1.bias": (3,),
             "aspp.aspp_1.0.weight": (2, 2),
             "aspp.aspp_1.0.bias": (2,),
             "resnet_backbone.res2.0.conv1.weight": (2,)}
    init = {n: rng.randn(*s).astype(np.float32) for n, s in names.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in names.items()}
             for _ in range(3)]
    tcfg = load_config(overrides={"train": {"warmup_iteration": 2}}).train
    sched = optim.make_schedule(tcfg)

    def nest(flat):  # 'a.b.c' keys -> nested dicts, as flax params
        out = {}
        for k, v in flat.items():
            node = out
            parts = k.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
        return out

    jparams = nest({n: jnp.asarray(v) for n, v in init.items()})
    tx = joptim.make_optimizer(jparams, tcfg)
    opt = tx.init(jparams)
    params = {n: torch.from_numpy(v.copy()).requires_grad_(True)
              for n, v in init.items()}
    bufs = {}
    for i, g in enumerate(grads):
        upd, opt = tx.update(nest({n: jnp.asarray(v) for n, v in g.items()}),
                             opt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n])
        optim.sgd_step(list(params.items()), bufs, sched(i),
                       tcfg.weight_decay, tcfg.momentum)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, v in flat:
        name = ".".join(getattr(k, "key", str(k)) for k in path)
        np.testing.assert_allclose(params[name].detach().numpy(),
                                   np.asarray(v), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_memory_bank_push_matches_jax():
    rng = np.random.RandomState(5)
    m, p, d, t = 2, 6, 4, 3
    jbank = jstate_lib.MemoryBank.create(m, p, d, 2, t)
    tbank = state_lib.MemoryBank.create(m, p, d, 2, t, "cpu")
    for _ in range(3):
        new = dict(
            prototype=rng.randn(p, d).astype(np.float32),
            prototype_with_loc=rng.randn(p, d + 2).astype(np.float32),
            semantic_label=rng.randint(0, 5, p).astype(np.int32),
            instance_label=rng.randint(0, 5, p).astype(np.int32),
            batch_index=rng.randint(0, 2, p).astype(np.int32),
            tag=rng.randint(0, 2, (p, t)).astype(np.int32),
            valid=rng.rand(p) > 0.5)
        jbank = jbank.push(**{k: jnp.asarray(v) for k, v in new.items()},
                           global_batch=2)
        tbank = tbank.push(**{k: torch.from_numpy(v) for k, v in
                              new.items()}, global_batch=2)
    for name in ("prototype", "prototype_with_loc", "semantic_label",
                 "instance_label", "batch_index", "tag", "valid"):
        np.testing.assert_array_equal(getattr(tbank, name).numpy(),
                                      np.asarray(getattr(jbank, name)),
                                      err_msg=name)


def test_config_fields_match_jax():
    """The port's schema is a subset of the JAX package's, with the same
    defaults, so one overrides dict configures both."""
    import dataclasses
    ours, theirs = load_config(), jload_config()
    for section in dataclasses.fields(ours):
        a, b = getattr(ours, section.name), getattr(theirs, section.name)
        if not dataclasses.is_dataclass(a):
            assert a == b, section.name
            continue
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), \
                f"{section.name}.{f.name}"
    cfg = load_config(overrides=OVERRIDES)
    jcfg = jload_config(overrides=OVERRIDES)
    assert cfg.tpu.segment_capacity == jcfg.tpu.segment_capacity == 32
    assert cfg.network.kmeans_num_clusters == (2, 2)


def test_fused_and_dense_loss_paths_agree():
    """tpu.use_fused_loss on (joint kernels' plain version on the CPU) and
    off (dense losses) give the same step from the same state (rtol 1e-5:
    float32 sums in another order)."""
    nb = _batch()
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    results = {}
    for fused_on in (True, False):
        cfg = load_config(overrides=OVERRIDES)
        cfg.tpu.use_fused_loss = fused_on
        st = tstep.init_state(cfg, 0, batch["image"], device="cpu")
        st.cls_model.semantic_classifier[3].p = 0.0
        _, m = tstep.make_train_step(cfg)(st, batch)
        results[fused_on] = m
    for k in ("loss", "sem_ann_loss", "sem_occ_loss", "img_sim_loss"):
        np.testing.assert_allclose(float(results[True][k]),
                                   float(results[False][k]), rtol=1e-5,
                                   err_msg=k)
