"""Model parity on the CPU: the port's EmbeddingModel (DeepLab and
DensePose PSPNet), PSPP, ClassifierHead and colour features against the
flax models and JAX functions, with the weights carried across by
spml_tpu_torch.utils.from_jax (which must load with strict=True).

float32 on both sides. Tolerance rtol 1e-4 / atol 1e-5 * max|ref|: ten
conv + BN layers of different convolution algorithms (XLA vs oneDNN)
compound float32 rounding; the running statistics after one train-mode
forward rtol 1e-4 / atol 1e-6. The DensePose model's train-mode outputs
atol 1e-4 * max|ref|: flax takes the batch variance as E[x^2] - E[x]^2,
which loses ~1e-7 E[x^2] in float32, and PSPP's 1-bin level normalizes
only B = 2 values per channel, where that loss is of the order of BN's
eps; against a float64 run of the port, the flax model is 5.5e-5 off at
max|ref| 1.25 and the port 8.4e-6. Pooling and the colour features (a few
sums and one resize) rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.models.embeddings import ClassifierHead as JHead
from spml_tpu.models.embeddings import build_embedding_model as jbuild
from spml_tpu.models import local as jlocal
from spml_tpu.models import spp as jspp
from spml_tpu_torch.models import local, spp
from spml_tpu_torch.models.embeddings import (EmbeddingModel,
                                              build_classifier_head,
                                              build_embedding_model)
from spml_tpu_torch.parallel import halo
from spml_tpu_torch.utils import from_jax

F32 = dict(rtol=1e-5, atol=1e-6)


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


def _check_model(jmodel, jvars, port, x_np, outputs_of, to_port=None,
                 train_rel_atol=1e-5):
    """Eval and train mode outputs and the updated running statistics;
    `to_port` maps the NHWC input to the port module's layout."""
    port.load_state_dict(from_jax_dict(jvars, port), strict=True)
    x = torch.from_numpy(x_np)
    if to_port is not None:
        x = to_port(x)
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
        _close(g.numpy(), w, rel_atol=train_rel_atol)
    new = from_jax_dict({"params": jvars["params"],
                         "batch_stats": _to_numpy(mut["batch_stats"])}, port)
    got_stats = _stats_of(port.state_dict())
    assert set(got_stats) == set(_stats_of(new))
    for k, v in _stats_of(new).items():
        np.testing.assert_allclose(got_stats[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def from_jax_dict(jvars, port):
    if isinstance(port, spp.PSPP):
        return from_jax.pspp_state_dict(jvars["params"],
                                        jvars["batch_stats"])
    if isinstance(port, EmbeddingModel):
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


def test_densepose_embedding_model_matches_flax():
    """panoptic_pspnet_10_densepose (PSPP head, colour + location local
    features), dim 8, 64x64 (res5 8x8: PSPP's 6-bin pool overlaps),
    float32: the embeddings and the 5 local channels, eval and train mode,
    and the running statistics (PSPP's BNs keep momentum 3e-4 whatever
    bn_momentum says)."""
    rng = np.random.RandomState(2)
    jmodel = jbuild("panoptic_pspnet_10_densepose", 8, dtype=jnp.float32,
                    bn_momentum=0.9)
    x_np = rng.rand(2, 64, 64, 3).astype(np.float32)
    jvars = _to_numpy(jmodel.init(jax.random.PRNGKey(2),
                                  jnp.asarray(x_np)))
    _perturb_bn(jvars["batch_stats"], rng)
    port = build_embedding_model("panoptic_pspnet_10_densepose", 8,
                                 bn_momentum=0.1)
    assert port.pspp[0].pspp_1[2].momentum == 3e-4
    _check_model(jmodel, jvars, port, x_np, lambda out: out,
                 train_rel_atol=1e-4)
    emb, loc = port(torch.from_numpy(x_np))
    assert emb.shape == (2, 16, 16, 8) and loc.shape == (2, 16, 16, 5)


def test_pspp_matches_flax():
    """PSPP alone, 16 -> 8 channels on a 5x7 map (bins larger than the
    map on both axes, the 6x6 level resized down)."""
    rng = np.random.RandomState(3)
    jmodel = jspp.PSPP(8, dtype=jnp.float32)
    x_np = rng.randn(2, 5, 7, 16).astype(np.float32)
    jvars = _to_numpy(jmodel.init(jax.random.PRNGKey(3),
                                  jnp.asarray(x_np)))
    _perturb_bn(jvars["batch_stats"], rng)
    port = spp.PSPP(16, 8)
    _check_model(jmodel, jvars, port, x_np,
                 lambda out: (out.permute(0, 2, 3, 1),),
                 to_port=lambda x: x.permute(0, 3, 1, 2))


@pytest.mark.parametrize("size", [4, 7, 64])
@pytest.mark.parametrize("bins", [1, 2, 3, 6])
def test_adaptive_avg_pool_matches_jax(size, bins):
    """PSPP's pool (halo.adaptive_avg_pools, unsharded) against the JAX
    package's adaptive_avg_pool: the same bins, also when the output is
    larger than the input (overlapping bins)."""
    rng = np.random.RandomState(size * 10 + bins)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    got, = halo.adaptive_avg_pools(torch.from_numpy(x).permute(0, 3, 1, 2),
                                   [bins])
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(),
        np.asarray(jspp.adaptive_avg_pool(jnp.asarray(x), bins)), **F32)


@pytest.mark.parametrize("hw,size", [((64, 64), (16, 16)),
                                     ((37, 45), (9, 11))])
def test_location_color_features_match_jax(hw, size):
    """[y, x, r, g, b] with the 5x5 blur, the resize from (H - 4, W - 4)
    to a non-integer fraction of it, and per-image normalization."""
    rng = np.random.RandomState(4)
    x = rng.rand(2, *hw, 3).astype(np.float32)
    np.testing.assert_allclose(local.gaussian_kernel(5).numpy(),
                               jlocal.gaussian_kernel(5), **F32)
    assert float(local.gaussian_kernel(5)[2, 2]) == 0.0
    got = local.location_color_features(
        torch.from_numpy(x), size, use_color=True, norm_color=True,
        smooth_ksize=5)
    want = jlocal.location_color_features(
        jnp.asarray(x), size, use_color=True, norm_color=True,
        smooth_ksize=5)
    assert got.shape == (2, *size, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
