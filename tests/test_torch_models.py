"""Model parity on the CPU: the port's EmbeddingModel and ClassifierHead
against the flax models, with the weights carried across by
spml_tpu_torch.utils.from_jax (which must load with strict=True).

float32 on both sides. Tolerance rtol 1e-4 / atol 1e-5 * max|ref|: ten
conv + BN layers of different convolution algorithms (XLA vs oneDNN)
compound float32 rounding; the running statistics after one train-mode
forward rtol 1e-4 / atol 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.models.embeddings import ClassifierHead as JHead
from spml_tpu.models.embeddings import build_embedding_model as jbuild
from spml_tpu_torch.models.embeddings import (build_classifier_head,
                                              build_embedding_model)
from spml_tpu_torch.utils import from_jax


def _close(got, want, rtol=1e-4, rel_atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel_atol * np.abs(want).max())


def _perturb_bn(tree, rng):
    """Non-trivial BN statistics / affine terms so eval mode is tested."""
    def visit(node):
        if isinstance(node, dict):
            if "mean" in node and "var" in node:
                node["mean"] = rng.randn(*node["mean"].shape).astype(
                    np.float32) * 0.1
                node["var"] = (0.5 + rng.rand(*node["var"].shape)).astype(
                    np.float32)
            for v in node.values():
                visit(v)
    visit(tree)


def _to_numpy(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _stats_of(sd):
    return {k: v.numpy() for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _check_model(jmodel, jvars, port, x_np, outputs_of):
    port.load_state_dict(from_jax_dict(jvars, port), strict=True)
    x = torch.from_numpy(x_np)
    # eval mode
    port.eval()
    with torch.no_grad():
        got = outputs_of(port(x))
    want = jmodel.apply(jvars, jnp.asarray(x_np), train=False)
    for g, w in zip(got, want if isinstance(want, tuple) else (want,)):
        _close(g.numpy(), w)
    # train mode: batch statistics, running statistics updated
    port.train()
    with torch.no_grad():
        got = outputs_of(port(x))
    want, mut = jmodel.apply(jvars, jnp.asarray(x_np), train=True,
                             mutable=["batch_stats"])
    for g, w in zip(got, want if isinstance(want, tuple) else (want,)):
        _close(g.numpy(), w)
    new = from_jax_dict({"params": jvars["params"],
                         "batch_stats": _to_numpy(mut["batch_stats"])}, port)
    got_stats = _stats_of(port.state_dict())
    assert set(got_stats) == set(_stats_of(new))
    for k, v in _stats_of(new).items():
        np.testing.assert_allclose(got_stats[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def from_jax_dict(jvars, port):
    if hasattr(port, "aspp"):
        return from_jax.embedding_state_dict(jvars["params"],
                                             jvars["batch_stats"])
    return from_jax.classifier_state_dict(jvars["params"],
                                          jvars["batch_stats"])


def test_embedding_model_matches_flax():
    """panoptic_deeplab_10, dim 8, 64x64, float32; BN momentum flax 0.9
    (torch 0.1) so the running-stat update is visible."""
    rng = np.random.RandomState(0)
    jmodel = jbuild("panoptic_deeplab_10", 8, dtype=jnp.float32,
                    bn_momentum=0.9)
    x_np = rng.randn(2, 64, 64, 3).astype(np.float32)
    jvars = _to_numpy(jmodel.init(jax.random.PRNGKey(0),
                                  jnp.asarray(x_np)))
    _perturb_bn(jvars["batch_stats"], rng)
    port = build_embedding_model("panoptic_deeplab_10", 8, bn_momentum=0.1)
    _check_model(jmodel, jvars, port, x_np, lambda out: out)


@pytest.mark.parametrize("hw", [(16, 16), (9, 13)])
def test_classifier_head_matches_flax(hw):
    """Dropout off (rate 0 on both sides: the RNG streams differ)."""
    rng = np.random.RandomState(1)
    jmodel = JHead(num_classes=5, hidden_dim=16, dropout_rate=0.0,
                   dtype=jnp.float32)
    x_np = rng.randn(2, *hw, 8).astype(np.float32)
    jvars = _to_numpy(jmodel.init(jax.random.PRNGKey(1),
                                  jnp.asarray(x_np)))
    _perturb_bn(jvars["batch_stats"], rng)
    port = build_classifier_head(5, 8, dropout_rate=0.0)
    _check_model(jmodel, jvars, port, x_np, lambda out: (out,))
