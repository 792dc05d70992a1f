"""The multi-scale pyramid and the softmax engine, port against the JAX
package on the CPU (tests/test_inference.py:80-438 are the JAX package's
own cases): the same flax variables (perturbed BN statistics) carried
over by spml_tpu_torch.utils.from_jax, float32, panoptic_deeplab_10 at
dim 8, 3 x 3 clusters, 3 k-means iterations, 4 classes, crop = stride =
32, so every pyramid member lies in one 32 x 32 bucket and the JAX side
compiles one member program an engine.

Tolerances: the bilinear weights exactly equal (the same float32
operations); resized values and member images rtol 1e-6 / atol 1e-6
(two-tap float32 sums in another order, values up to 1); a member's
probabilities exactly equal (means of 20 one-hots, equal as the
retrieved labels are); the KNN pyramid at float32 rtol 1e-6 / atol 1e-6
(its resize sums) and at float16 within one float16 rounding (rtol
2^-10) of JAX's; the softmax pyramid rtol 1e-4 / atol 1e-5 (the conv
stack's float32 rounding, as tests/test_torch_inference_engine.py) and,
at float16, that plus one float16 rounding; labels on the device equal.
"""

import concurrent.futures

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.inference import engine as jengine
from spml_tpu.inference import msc as jmsc
from spml_tpu.inference.softmax import \
    SoftmaxInferenceEngine as JSoftmaxEngine
from spml_tpu.models.embeddings import (INIT_SAMPLE_HW, ClassifierHead,
                                        host_init,
                                        build_embedding_model as jbuild)
from spml_tpu.ops import kmeans as jkmeans
from spml_tpu_torch.config import load_config
from spml_tpu_torch.inference import engine, msc
from spml_tpu_torch.inference.softmax import SoftmaxInferenceEngine
from spml_tpu_torch.models.embeddings import (build_classifier_head,
                                              build_embedding_model)
from spml_tpu_torch.ops import kmeans
from spml_tpu_torch.utils import from_jax
from test_torch_inference_engine import _perturb_bn

OVERRIDES = {
    "network": {"backbone_types": "panoptic_deeplab_10",
                "embedding_dim": 8, "kmeans_num_clusters": [3, 3],
                "kmeans_iterations": 3},
    "dataset": {"num_classes": 4},
    "test": {"crop_size": [32, 32], "stride": [32, 32], "image_size": 0},
    "tpu": {"compute_dtype": "float32"},
}
SCALES = (0.75, 1.0)
F16_RTOL = 2.0 ** -10  # one float16 rounding, halved for the division


@pytest.fixture(scope="module")
def engines():
    """(JAX KNN, port KNN, JAX softmax, port softmax engines, the image,
    JAX memory, port memory)."""
    jmodel = jbuild("panoptic_deeplab_10", 8)
    jvars = host_init(jmodel, jax.random.PRNGKey(3),
                      np.zeros((1, *INIT_SAMPLE_HW, 3), np.float32))
    jvars = jax.tree.map(np.array, jvars)
    _perturb_bn(jvars["batch_stats"], np.random.RandomState(0))
    jcls = ClassifierHead(num_classes=4, hidden_dim=16)
    cvars = host_init(jcls, jax.random.PRNGKey(4),
                      np.zeros((1, 8, 8, 8), np.float32))
    cvars = jax.tree.map(np.array, cvars)
    _perturb_bn(cvars["batch_stats"], np.random.RandomState(1))

    model = build_embedding_model("panoptic_deeplab_10", 8)
    model.load_state_dict(from_jax.embedding_state_dict(
        jvars["params"], jvars["batch_stats"]), strict=True)
    head = build_classifier_head(4, 8)
    head.load_state_dict(from_jax.classifier_state_dict(
        cvars["params"], cvars["batch_stats"]), strict=True)

    jcfg, cfg = jload_config(overrides=OVERRIDES), \
        load_config(overrides=OVERRIDES)
    jeng = jengine.InferenceEngine(jcfg, jmodel, jvars)
    eng = engine.InferenceEngine(cfg, model, device="cpu")
    jseng = JSoftmaxEngine(jcfg, jmodel, jvars, jcls, cvars)
    seng = SoftmaxInferenceEngine(cfg, model, head, device="cpu")

    rng = np.random.RandomState(6)
    img = rng.randn(30, 29, 3).astype(np.float32)
    gt = np.zeros((30, 29), np.int32)
    gt[15:, :] = 2
    gt[:, 20:] = 3
    p, lab, val = jeng.build_prototypes(img, gt)
    noise = rng.randn(30, 8).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    mem = (np.concatenate([np.tile(p[val], (12, 1)), noise]),
           np.concatenate([np.tile(lab[val], 12),
                           rng.randint(0, 4, 30)]).astype(np.int32),
           np.ones(12 * int(val.sum()) + 30, bool))
    jmem = tuple(jnp.asarray(m) for m in mem)
    return jeng, eng, jseng, seng, img, jmem, eng.memory(*mem)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("sizes", [(32, 32, 22, 30), (48, 40, 45, 31),
                                   (24, 40, 17, 29)])
def test_bilinear_resize_weights_match_jax(sizes, reverse):
    """Bucket-shaped weights at ragged valid sizes, up and down."""
    n_out, n_in, valid_out, valid_in = sizes
    want = np.asarray(jmsc.bilinear_resize_weights(
        n_out, n_in, jnp.float32(valid_out), jnp.float32(valid_in),
        reverse))
    got = msc.bilinear_resize_weights(n_out, n_in, valid_out, valid_in,
                                      reverse).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flip", [False, True])
def test_resize_accumulate_matches_jax(flip):
    """A member's probabilities [32, 32, 4] valid in 22 x 21, added to a
    sum at the base size 30 x 29 (JAX's sum is bucket-shaped; its valid
    region is compared)."""
    rng = np.random.RandomState(1)
    probs = rng.rand(32, 32, 4).astype(np.float32)
    acc = rng.rand(32, 32, 4).astype(np.float32)
    want = np.asarray(jmsc.resize_accumulate_body(
        jnp.asarray(acc), jnp.asarray(probs), jnp.asarray([22, 21]),
        jnp.asarray([30, 29]), flip))[:30, :29]
    got = msc.resize_accumulate(torch.from_numpy(acc[:30, :29].copy()),
                                torch.from_numpy(probs), (22, 21),
                                flip).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("flip", [0, 1])
@pytest.mark.parametrize("member_hw", [(22, 21), (37, 36)])
def test_device_member_resize_matches_jax(flip, member_hw):
    """Members of a 30 x 29 base in a 32 x 32 bucket (down) and a 48 x 48
    one (up), the flip inside the valid region, zeros past it."""
    rng = np.random.RandomState(2)
    base = np.zeros((32, 32, 3), np.float32)
    base[:30, :29] = rng.randn(30, 29, 3)
    bucket = engine.bucket_dim(member_hw[0], 32, 16), \
        engine.bucket_dim(member_hw[1], 32, 16)
    want = np.asarray(jengine.device_member_resize(
        jnp.asarray(base), jnp.asarray([30, 29]), jnp.asarray(member_hw),
        jnp.asarray(flip), bucket))
    got = engine.device_member_resize(torch.from_numpy(base), (30, 29),
                                      member_hw, bool(flip), bucket).numpy()
    assert got.shape == (*bucket, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[member_hw[0]:].any() and not got[:, member_hw[1]:].any()


def test_member_pair_matches_jax(engines):
    """Both flips of scale 0.75 through one window forward: the member
    probabilities (means of 20 one-hots) exactly equal JAX's pair."""
    jeng, eng, _, _, img, jmem, mem = engines
    base = eng.upload_image(img)
    want = np.asarray(jeng.predict_member_pair_probs(
        jnp.asarray(base.numpy()), jnp.asarray([30, 29]), (22, 21), *jmem))
    got = eng.predict_member_pair_probs(base, (30, 29), (22, 21), *mem)
    np.testing.assert_array_equal(got.numpy(), want)
    one = eng.predict_member_probs(base, (30, 29), (22, 21), True, *mem)
    np.testing.assert_array_equal(one.numpy(), want[1])


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_knn_device_pyramid_matches_jax(engines, dtype):
    jeng, eng, _, _, img, jmem, mem = engines
    want = jmsc.msc_predict_probs_device(jeng, img, jmem, SCALES, True,
                                         transfer_dtype=dtype)
    got = msc.msc_predict_probs_device(eng, img, mem, SCALES, True,
                                       transfer_dtype=dtype)
    assert got.shape == want.shape == (30, 29, 4)
    assert got.dtype == np.float32
    rtol = 1e-6 if dtype == np.float32 else F16_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=2e-3)


def test_knn_pyramid_without_flip_matches_jax(engines):
    """is_flip False: each member alone (predict_member_probs)."""
    jeng, eng, _, _, img, jmem, mem = engines
    want = jmsc.msc_predict_probs_device(jeng, img, jmem, SCALES, False,
                                         transfer_dtype=np.float32)
    got = msc.msc_predict_probs_device(eng, img, mem, SCALES, False,
                                       transfer_dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_async_resolve_on_a_thread_equals_sync(engines):
    _, eng, _, _, img, _, mem = engines
    sync = msc.msc_predict_probs_device(eng, img, mem, SCALES)
    resolve = msc.msc_predict_probs_device_async(eng, img, mem, SCALES)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        got = pool.submit(resolve).result()
    assert got.dtype == sync.dtype == np.float32
    np.testing.assert_array_equal(got, sync)


@pytest.mark.parametrize("final_hw", [None, (45, 43)])
def test_knn_labels_on_device_match_jax(engines, final_hw):
    """The float32 sum resized to the final size and argmaxed on the
    device, at the image's size and at a larger original size."""
    jeng, eng, _, _, img, jmem, mem = engines
    want = jmsc.msc_predict_labels_device(jeng, img, jmem, SCALES, True,
                                          final_hw=final_hw)
    got = msc.msc_predict_labels_device(eng, img, mem, SCALES, True,
                                        final_hw=final_hw)
    assert got.dtype == np.uint8 and got.shape == (final_hw or (30, 29))
    np.testing.assert_array_equal(got, want)


def test_host_pyramid_matches_jax(engines):
    """msc_predict_probs over host-resized members (PIL) and the
    single-image probabilities."""
    jeng, eng, _, _, img, jmem, mem = engines
    want = jmsc.msc_predict_probs(
        lambda im: jeng.predict_topk_probs(im, *jmem), img, SCALES, True)
    got = msc.msc_predict_probs(
        lambda im: eng.predict_topk_probs(im, *mem), img, SCALES, True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_softmax_probs_match_jax(engines):
    _, _, jseng, seng, img, _, _ = engines
    want = jseng.predict_probs(img)
    got = seng.predict_probs(img)
    assert got.shape == want.shape == (30, 29, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_softmax_device_pyramid_matches_jax(engines, dtype):
    _, _, jseng, seng, img, _, _ = engines
    want = jmsc.msc_predict_probs_device(jseng, img, (), SCALES, True,
                                         transfer_dtype=dtype)
    got = msc.msc_predict_probs_device(seng, img, (), SCALES, True,
                                       transfer_dtype=dtype)
    rtol = 1e-4 if dtype == np.float32 else 1e-4 + F16_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5)


def test_softmax_labels_on_device_match_jax(engines):
    _, _, jseng, seng, img, _, _ = engines
    want = jmsc.msc_predict_labels_device(jseng, img, (), SCALES, True,
                                          final_hw=(45, 43))
    got = msc.msc_predict_labels_device(seng, img, (), SCALES, True,
                                        final_hw=(45, 43))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_valid", [False, True])
def test_find_majority_label_index_matches_jax(with_valid):
    """Labels 0-4 of 4 classes (4 votes for none), 6 clusters one of them
    empty, ties among them."""
    rng = np.random.RandomState(3)
    sem = rng.randint(0, 5, 200).astype(np.int32)
    clusters = rng.randint(0, 5, 200).astype(np.int32)
    valid = rng.rand(200) < 0.7 if with_valid else None
    jsel, jmaj = jkmeans.find_majority_label_index(
        jnp.asarray(sem), jnp.asarray(clusters), 6, 4,
        None if valid is None else jnp.asarray(valid))
    sel, maj = kmeans.find_majority_label_index(
        torch.from_numpy(sem), torch.from_numpy(clusters), 6, 4,
        None if valid is None else torch.from_numpy(valid))
    assert maj.dtype == torch.int32
    np.testing.assert_array_equal(maj.numpy(), np.asarray(jmaj))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
