"""Batched single-scale KNN prediction of the port
(InferenceEngine.predict_semantic_batch, runner._PredictBatcher) against
the JAX package's (predict_semantic_batch with mesh=None) on the CPU.

The weights, float32, panoptic_deeplab_10 at dim 8 and 3 x 3 clusters of
tests/test_torch_inference_engine.py; crop 32, stride 16 with pad
buckets, so 25-32 px images share the 32 x 32 bucket and 33-48 px ones
the 48 x 48 one (2 x 2 windows); a bank of 40 random unit vectors with 4
labels, five of them invalid.

* Same-bucket groups and a mixed group (padded to its largest bucket, so
  the small images see the big bucket's window grid): predictions
  exactly JAX's; the group's stitched maps within rtol 1e-4 / atol 1e-5 *
  max|JAX| (the conv stack's float32 rounding, as the engine test).
* Same-bucket groups equal the port's own predict_semantic per image.
* run_knn_inference with tpu.infer_batch 2 over the pipeline test's
  three images (two share a bucket, the third is left for flush_all)
  writes the PNGs of the JAX runner with infer_batch 2, and those of the
  port's per-image run.
* An empty group gives [].
"""

import copy
import os

import numpy as np
import jax
import PIL.Image
import pytest
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.inference import engine as jengine
from spml_tpu.inference import runner as jrunner
from spml_tpu_torch.config import load_config
from spml_tpu_torch.inference import engine, runner
from spml_tpu_torch.models.embeddings import build_embedding_model
from spml_tpu_torch.utils import from_jax
from test_torch_inference_engine import _overrides, weights  # noqa: F401
from test_torch_inference_runner import runs  # noqa: F401

SMALL = [(32, 32), (30, 28), (25, 32)]  # the 32 x 32 bucket
BIG = [(40, 33), (48, 40)]  # the 48 x 48 bucket


@pytest.fixture(scope="module")
def engines(weights):  # noqa: F811
    jmodel, jvars = weights
    jeng = jengine.InferenceEngine(jload_config(
        overrides=_overrides(32, 16, True)), jmodel, jvars)
    model = build_embedding_model("panoptic_deeplab_10", 8)
    model.load_state_dict(from_jax.embedding_state_dict(
        jvars["params"], jvars["batch_stats"]), strict=True)
    eng = engine.InferenceEngine(load_config(
        overrides=_overrides(32, 16, True)), model, device="cpu")
    rng = np.random.RandomState(0)
    mem_p = rng.randn(40, 8).astype(np.float32)
    mem_p /= np.linalg.norm(mem_p, axis=1, keepdims=True)
    mem_l = rng.randint(0, 4, 40).astype(np.int32)
    mem_v = np.ones(40, bool)
    mem_v[-5:] = False
    images = {hw: rng.randn(*hw, 3).astype(np.float32)
              for hw in SMALL + BIG}
    return jeng, eng, (mem_p, mem_l, mem_v), images


@pytest.mark.parametrize("group", ["small", "big", "mixed"])
def test_batch_matches_jax(engines, group):
    jeng, eng, memory, images = engines
    shapes = {"small": SMALL, "big": BIG, "mixed": SMALL[:2] + BIG}[group]
    imgs = [images[hw] for hw in shapes]
    want = jeng.predict_semantic_batch(imgs, *memory, mesh=None)
    got = eng.predict_semantic_batch(imgs, *memory)
    assert len(got) == len(want) == len(imgs)
    for g, w, hw in zip(got, want, shapes):
        assert g.dtype == np.int32 and g.shape == w.shape == hw
        np.testing.assert_array_equal(g, w)
    pad = (32, 32) if group == "small" else (48, 48)
    padded = np.zeros((len(imgs), *pad, 3), np.float32)
    for i, im in enumerate(imgs):
        padded[i, :im.shape[0], :im.shape[1]] = im
    want_map = np.asarray(jax.jit(jeng._stitch_batched_impl)(padded))
    got_map = eng.stitch(torch.from_numpy(padded)).numpy()
    np.testing.assert_allclose(got_map, want_map, rtol=1e-4,
                               atol=1e-5 * np.abs(want_map).max())


@pytest.mark.parametrize("shapes", [SMALL, BIG], ids=["small", "big"])
def test_same_bucket_group_equals_per_image(engines, shapes):
    _, eng, memory, images = engines
    imgs = [images[hw] for hw in shapes]
    for got, im in zip(eng.predict_semantic_batch(imgs, *memory), imgs):
        np.testing.assert_array_equal(got,
                                      eng.predict_semantic(im, *memory))


def test_empty_group(engines):
    _, eng, memory, _ = engines
    assert eng.predict_semantic_batch([], *memory) == []


def _pngs(save_dir):
    out = {}
    for sub in ("semantic_gray", "semantic_color"):
        for name in sorted(os.listdir(os.path.join(save_dir, sub))):
            out[sub, name] = np.array(PIL.Image.open(
                os.path.join(save_dir, sub, name)))
    return out


def test_run_knn_inference_batched_matches_jax(
        runs, tmp_path, monkeypatch):  # noqa: F811
    """infer_batch 2: im0 and im2 (48 x 64) share a bucket and go as one
    group; im1 (61 x 40) is left for flush_all."""
    (jargs, jcfg), (args, cfg) = runs
    jcfg, cfg = copy.deepcopy(jcfg), copy.deepcopy(cfg)
    jcfg.tpu.infer_batch = cfg.tpu.infer_batch = 2
    jargs, args = copy.copy(jargs), copy.copy(args)
    per_image = _pngs(args.save_dir)
    jargs.save_dir, args.save_dir = str(tmp_path / "jax"), str(
        tmp_path / "port")
    groups = []
    predict = engine.InferenceEngine.predict_semantic_batch

    def recording(self, images, *memory):
        groups.append([im.shape[:2] for im in images])
        return predict(self, images, *memory)

    monkeypatch.setattr(engine.InferenceEngine, "predict_semantic_batch",
                        recording)
    runner.run_knn_inference(args, cfg, device="cpu")
    jrunner.run_knn_inference(jargs, jcfg)
    assert len(groups) == 2 and sorted(len(g) for g in groups) == [1, 2]
    got, want = _pngs(args.save_dir), _pngs(jargs.save_dir)
    assert got.keys() == want.keys() == per_image.keys()
    assert len(got) == 6
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
        np.testing.assert_array_equal(got[k], per_image[k],
                                      err_msg=str(k))
