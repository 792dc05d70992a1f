"""The single-scale KNN pipeline end to end, port against the JAX package
on the CPU: run_prototype -> run_knn_inference -> run_benchmark over a
synthetic three-image list, each package into its own save dir, from one
reference-format snapshot (`model-{max_iteration - 1}.pth`, written by
the JAX package's save_torch_checkpoint) that both load.

test.image_size is 0, so the JAX runner warms no program per bucket.
Memory banks: the same file names, pickle layout, dtypes and shapes, the
labels' bytes equal, every byte outside the prototypes' float32 payload
equal, and the prototypes within rtol 1e-4 / atol 1e-6 (the conv stack's
float32 rounding, as tests/test_torch_inference_engine.py). The cluster
maps, the semantic_gray label maps, their colour PNGs and the benchmark
results (mIoU and instance-weighted, and what each prints) exactly
equal.
"""

import argparse
import os

import numpy as np
import jax
import PIL.Image
import pytest

from spml_tpu.config import load_config as jload_config
from spml_tpu.inference import runner as jrunner
from spml_tpu.models.embeddings import (INIT_SAMPLE_HW, ClassifierHead,
                                        build_embedding_model, host_init)
from spml_tpu.utils import torch_export
from spml_tpu_torch.config import load_config
from spml_tpu_torch.inference import runner

OVERRIDES = {
    "dataset": {"num_classes": 4},
    "network": {"backbone_types": "panoptic_deeplab_10",
                "embedding_dim": 8, "kmeans_iterations": 3,
                "kmeans_num_clusters": [3, 3]},
    "train": {"max_iteration": 10},
    "test": {"image_size": 0, "crop_size": [48, 48], "stride": [32, 32]},
    "tpu": {"compute_dtype": "float32"},
}


def _write_snapshot(snap):
    """Random flax variables (not PRNGKey(0)'s, so the file is what both
    load) exported to the reference's .pth."""
    os.makedirs(snap)
    emb = build_embedding_model("panoptic_deeplab_10", 8)
    evars = host_init(emb, jax.random.PRNGKey(7),
                      np.zeros((1, *INIT_SAMPLE_HW, 3), np.float32))
    cls = ClassifierHead(num_classes=4, hidden_dim=16)
    cvars = host_init(cls, jax.random.PRNGKey(8),
                      np.zeros((1, 24, 24, 8), np.float32))
    torch_export.save_torch_checkpoint(
        os.path.join(snap, "model-9.pth"),
        {"embedding": evars["params"], "prediction": cvars["params"]},
        {"embedding": evars["batch_stats"],
         "prediction": cvars["batch_stats"]})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three images (48 x 64 and 61 x 40: 1 x 2 and 2 x 1 windows),
    labels in halves with an ignored strip, and a snapshot; both
    packages' run_prototype and run_knn_inference. Returns (JAX args and
    config, port args and config)."""
    tmp_path = tmp_path_factory.mktemp("world")
    rng = np.random.RandomState(0)
    data = tmp_path / "data"
    for sub in ("JPEGImages", "segcls", "seginst"):
        (data / sub).mkdir(parents=True)
    lines = []
    for i, (h, w) in enumerate(((48, 64), (61, 40), (48, 64))):
        img = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        sem = np.zeros((h, w), np.uint8)
        sem[:, w // 2:] = 1 + (i % 3)
        sem[:3] = 255
        inst = rng.randint(0, 4, (h, w)).astype(np.uint8)
        PIL.Image.fromarray(img).save(data / "JPEGImages" / f"im{i}.jpg")
        PIL.Image.fromarray(sem).save(data / "segcls" / f"im{i}.png")
        PIL.Image.fromarray(inst).save(data / "seginst" / f"im{i}.png")
        lines.append(f"JPEGImages/im{i}.jpg segcls/im{i}.png "
                     f"seginst/im{i}.png")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    _write_snapshot(str(tmp_path / "snap"))

    def args(save):
        return argparse.Namespace(
            snapshot_dir=str(tmp_path / "snap"), save_dir=str(save),
            data_dir=str(data), data_list=str(tmp_path / "list.txt"),
            semantic_memory_dir=str(save / "semantic_prototype"))
    jargs, args = args(tmp_path / "jax"), args(tmp_path / "port")
    jcfg, cfg = jload_config(overrides=OVERRIDES), \
        load_config(overrides=OVERRIDES)
    jrunner.run_prototype(jargs, jcfg)
    runner.run_prototype(args, cfg, device="cpu")
    jrunner.run_knn_inference(jargs, jcfg)
    runner.run_knn_inference(args, cfg, device="cpu")
    return (jargs, jcfg), (args, cfg)


def _differing_bytes_lie_in(a: bytes, b: bytes, payload: bytes):
    """True when a and b have one length and every byte where they differ
    lies inside the one occurrence of `payload` in a."""
    start = a.find(payload)
    assert start >= 0 and a.find(payload, start + 1) < 0
    diff = np.flatnonzero(np.frombuffer(a, np.uint8)
                          != np.frombuffer(b, np.uint8))
    return diff.size == 0 or (diff.min() >= start
                              and diff.max() < start + len(payload))


def _png(args, sub, name):
    return np.array(PIL.Image.open(os.path.join(args.save_dir, sub, name)))


def test_memory_banks_match_jax(runs):
    (jargs, _), (args, _) = runs
    names = sorted(os.listdir(jargs.semantic_memory_dir))
    assert names == ["im0.npy", "im1.npy", "im2.npy"]
    assert sorted(os.listdir(args.semantic_memory_dir)) == names
    for name in names:
        jpath = os.path.join(jargs.semantic_memory_dir, name)
        path = os.path.join(args.semantic_memory_dir, name)
        want = np.load(jpath, allow_pickle=True).item()
        got = np.load(path, allow_pickle=True).item()
        for k in ("prototype", "prototype_label"):
            assert got[k].dtype == want[k].dtype
            assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got["prototype_label"],
                                      want["prototype_label"])
        np.testing.assert_allclose(got["prototype"], want["prototype"],
                                   rtol=1e-4, atol=1e-6)
        with open(jpath, "rb") as f, open(path, "rb") as g:
            assert _differing_bytes_lie_in(
                f.read(), g.read(), want["prototype"].tobytes())


@pytest.mark.parametrize("sub", ["semantic_cluster", "semantic_cluster_rgb",
                                 "semantic_gray", "semantic_color"])
def test_pngs_match_jax(runs, sub):
    """The cluster maps of run_prototype and the predictions of
    run_knn_inference, at each image's original size."""
    (jargs, _), (args, _) = runs
    for name in ("im0.png", "im1.png", "im2.png"):
        np.testing.assert_array_equal(_png(args, sub, name),
                                      _png(jargs, sub, name),
                                      err_msg=f"{sub}/{name}")
    gray = _png(args, "semantic_gray", "im1.png")
    assert gray.shape == (61, 40) and gray.max() < 4


@pytest.mark.parametrize("instance", [False, True])
def test_benchmark_matches_jax(runs, capsys, instance):
    (jargs, jcfg), (args, cfg) = runs
    capsys.readouterr()
    want = jrunner.run_benchmark(jargs, jcfg, instance=instance)
    want_out = capsys.readouterr().out
    got = runner.run_benchmark(args, cfg, instance=instance)
    assert capsys.readouterr().out == want_out
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["class_iou"], want["class_iou"])
    assert got["mean_iou"] == want["mean_iou"] > 0

