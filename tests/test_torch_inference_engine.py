"""The port's InferenceEngine against the JAX package's on the CPU, same
weights (flax variables with perturbed BN statistics, carried over by
spml_tpu_torch.utils.from_jax), float32, panoptic_deeplab_10 at dim 8,
3x3 clusters, 5 k-means iterations.

Cases: a square image in one window (crop = stride = 32), and a ragged
40 x 33 image under crop 32 / stride 16 (2 x 2 windows), each with
tpu.pad_to_stride_buckets on and off. The JAX side runs its fused
programs (the default; the JAX package's tests hold them equal to its
eager ones) and, for the stitched map, `_stitch_impl` under jit.

Tolerances: the stitched embeddings rtol 1e-4 / atol 1e-5 * max|ref| (the
conv stack's float32 rounding, as tests/test_torch_models.py); the
prototypes rtol 1e-4 / atol 1e-6 (normalized sums of those embeddings);
probabilities, means of 20 one-hots, exactly equal, as the retrieved
labels are (the bank holds each built prototype 12 times and 30 random
unit vectors, so a top 20 mixes labels). Cluster maps, prototype labels and validity, and
predictions exactly equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.inference import engine as jengine
from spml_tpu.models.embeddings import (INIT_SAMPLE_HW, host_init,
                                        build_embedding_model as jbuild)
from spml_tpu_torch.config import load_config
from spml_tpu_torch.inference import engine
from spml_tpu_torch.models.embeddings import build_embedding_model
from spml_tpu_torch.utils import from_jax

CASES = {  # name -> (crop, stride, image h, w, pad_to_stride_buckets)
    "square_buckets": (32, 32, 32, 32, True),
    "square_no_buckets": (32, 32, 32, 32, False),
    "ragged_buckets": (32, 16, 40, 33, True),
    "ragged_no_buckets": (32, 16, 40, 33, False),
}


def _overrides(crop, stride, pad):
    return {
        "network": {"backbone_types": "panoptic_deeplab_10",
                    "embedding_dim": 8, "kmeans_num_clusters": [3, 3],
                    "kmeans_iterations": 5},
        "dataset": {"num_classes": 4},
        "test": {"crop_size": [crop, crop], "stride": [stride, stride],
                 "image_size": 0},
        "tpu": {"compute_dtype": "float32", "pad_to_stride_buckets": pad},
    }


def _perturb_bn(tree, rng):
    """Non-trivial running statistics, so eval-mode BN is exercised."""
    if isinstance(tree, dict):
        if "mean" in tree and "var" in tree:
            tree["mean"] = (0.1 * rng.randn(*tree["mean"].shape)).astype(
                np.float32)
            tree["var"] = (0.5 + rng.rand(*tree["var"].shape)).astype(
                np.float32)
        for v in tree.values():
            _perturb_bn(v, rng)


@pytest.fixture(scope="module")
def weights():
    jmodel = jbuild("panoptic_deeplab_10", 8)
    jvars = host_init(jmodel, jax.random.PRNGKey(3),
                      np.zeros((1, *INIT_SAMPLE_HW, 3), np.float32))
    jvars = jax.tree.map(np.array, jvars)
    _perturb_bn(jvars["batch_stats"], np.random.RandomState(0))
    return jmodel, jvars


_RUNS = {}


def _run(name, weights):
    """Both engines on one case: the JAX and port results, cached per
    case for the module."""
    if name in _RUNS:
        return _RUNS[name]
    crop, stride, h, w, pad = CASES[name]
    jmodel, jvars = weights
    jeng = jengine.InferenceEngine(jload_config(
        overrides=_overrides(crop, stride, pad)), jmodel, jvars)
    cfg = load_config(overrides=_overrides(crop, stride, pad))
    model = build_embedding_model("panoptic_deeplab_10", 8)
    model.load_state_dict(from_jax.embedding_state_dict(
        jvars["params"], jvars["batch_stats"]), strict=True)
    eng = engine.InferenceEngine(cfg, model, device="cpu")

    rng = np.random.RandomState(5)
    img = rng.randn(h, w, 3).astype(np.float32)
    gt = np.zeros((h, w), np.int32)
    gt[h // 2:, :] = 2
    gt[:4, :5] = 255  # an ignored corner
    jbuilt = jeng.build_prototypes(img, gt, return_clusters=True)
    built = eng.build_prototypes(img, gt, return_clusters=True)
    # the JAX bank: each valid prototype 12 times, then 30 random unit
    # vectors with random labels, so a top 20 holds other prototypes too
    p, lab, val = jbuilt[:3]
    noise = rng.randn(30, p.shape[1]).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    mem_p = np.concatenate([np.tile(p[val], (12, 1)), noise])
    mem_l = np.concatenate([np.tile(lab[val], 12),
                            rng.randint(0, 4, 30)]).astype(np.int32)
    mem_v = np.ones(mem_p.shape[0], bool)
    mem_v[-5:] = False
    jmem = (jnp.asarray(mem_p), jnp.asarray(mem_l), jnp.asarray(mem_v))
    pad_hw = jeng.bucket_shape(h, w)
    padded = np.zeros((*pad_hw, 3), np.float32)
    padded[:h, :w] = img
    out = {
        "bucket": (jeng.bucket_shape(h, w), eng.bucket_shape(h, w)),
        "stitch": (np.asarray(jax.jit(jeng._stitch_impl)(padded)),
                   eng.stitched_embeddings(img).numpy()),
        "build": (jbuilt, built),
        "predict": (jeng.predict_semantic(img, *jmem),
                    eng.predict_semantic(img, mem_p, mem_l, mem_v)),
        "probs": (jeng.predict_topk_probs(img, *jmem),
                  eng.predict_topk_probs(img, mem_p, mem_l, mem_v)),
        "shape": (h, w),
    }
    _RUNS[name] = out
    return out


@pytest.mark.parametrize("name", CASES)
def test_stitched_embeddings_match_jax(name, weights):
    r = _run(name, weights)
    want, got = r["stitch"]
    jb, pb = r["bucket"]
    assert jb == pb and got.shape == want.shape == (*jb, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", CASES)
def test_build_prototypes_match_jax(name, weights):
    r = _run(name, weights)
    (jp, jl, jv, jc), (p, lab, v, c) = r["build"]
    assert p.dtype == np.float32 and lab.dtype == np.int32
    assert v.dtype == bool and c.dtype == np.int32
    assert c.shape == r["shape"] and p.shape == (9, 8)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(lab, jl)
    np.testing.assert_allclose(p, jp, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_predict_semantic_matches_jax(name, weights):
    want, got = _run(name, weights)["predict"]
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CASES)
def test_predict_topk_probs_match_jax(name, weights):
    want, got = _run(name, weights)["probs"]
    assert got.dtype == np.float32 and got.shape == (*want.shape[:2], 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def test_bucket_grid_changes_with_the_option(weights):
    """Buckets on: the ragged image pads to 48 x 48, windows at rows and
    columns 0 and 16; off: to 40 x 33, windows at rows 0, 8 and columns
    0, 1."""
    assert _run("ragged_buckets", weights)["bucket"][1] == (48, 48)
    assert _run("ragged_no_buckets", weights)["bucket"][1] == (40, 33)
    cfg = load_config(overrides=_overrides(32, 16, True))
    eng = engine.InferenceEngine(cfg, torch.nn.Identity(), device="cpu")
    assert eng.windows(48, 48) == [(0, 0), (0, 16), (16, 0), (16, 16)]
    assert eng.windows(40, 33) == [(0, 0), (0, 1), (8, 0), (8, 1)]


def test_memory_bank_files_match_jax(tmp_path):
    """save_prototypes writes the same bytes as JAX's for the same arrays;
    load_memory_banks reads JAX's files back to equal arrays."""
    rng = np.random.RandomState(2)
    for i in range(3):
        p = rng.randn(4 + i, 8).astype(np.float32)
        lab = rng.randint(0, 21, 4 + i).astype(np.int32)
        jengine.save_prototypes(str(tmp_path / f"j{i}.npy"), p, lab)
        engine.save_prototypes(str(tmp_path / f"t{i}.npy"), p, lab)
        assert (tmp_path / f"j{i}.npy").read_bytes() == \
            (tmp_path / f"t{i}.npy").read_bytes()
    (tmp_path / "notes.txt").write_text("not a bank")
    jp, jl = jengine.load_memory_banks(str(tmp_path))
    p, lab = engine.load_memory_banks(str(tmp_path))
    assert p.shape == (2 * 15, 8)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(lab, jl)
    assert p.dtype == np.float32 and lab.dtype == np.int32


def test_all_ignore_cluster_gets_label_zero():
    """A cluster none of whose pixels carries a valid label gets label 0,
    the argmax of an empty histogram, as the JAX engine's _majority_impl;
    out-of-range labels count for none."""
    seg = torch.tensor([0, 0, 1, 1, 2, 2])
    lab = torch.tensor([3, 3, 255, 255, 7, 300])
    valid = lab != 255
    got = engine.InferenceEngine.majority_labels(seg, lab, valid, 4)
    want = jengine.InferenceEngine._majority_impl(
        jnp.asarray(seg.numpy()), jnp.asarray(lab.numpy()),
        jnp.asarray(valid.numpy()), 4, num_bins=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [3, 0, 7, 0]
