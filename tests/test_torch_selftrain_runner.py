"""The self-training chain's runners, port against the JAX package on the
CPU: KNN inference with each msc / crf combination, softmax inference,
and the four pseudo-label paths, each package into its own save dir, from
one reference-format snapshot (`model-{max_iteration - 1}.pth`, written
by the JAX package's save_torch_checkpoint: an embedding and a classifier
head) that both load, and one memory bank (the port's run_prototype's).

The world: 3 images of 48 x 64 and 61 x 40 with blobby 4-class labels
and instance maps (spml_tpu_torch/data/synthetic.py, seed 3), their CAMs
(write_cams), and a DensePose world of 2 images with 40 labelled points
each in 15 classes. float32, panoptic_deeplab_10 at dim 8, test.image_size
0 (the JAX runners warm no bucket), crop = stride = 64, so every image
and every pyramid member (scales 0.75 and 1) lies in one 64 x 64 bucket;
the CRF at the reference's defaults. Gray and colour PNGs exactly equal.
The JAX side compiles its programs anew in each runner call, so the cases
are the KNN paths new here, the recipe's softmax and pseudo-label steps
and the other three pseudo-label paths; the single-scale KNN path is
tests/test_torch_inference_runner.py's.
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
from spml_tpu_torch.data import synthetic
from spml_tpu_torch.inference import runner

OVERRIDES = {
    "dataset": {"num_classes": 4},
    "network": {"backbone_types": "panoptic_deeplab_10",
                "embedding_dim": 8, "kmeans_iterations": 3,
                "kmeans_num_clusters": [3, 3]},
    "train": {"max_iteration": 10},
    "test": {"image_size": 0, "crop_size": [64, 64], "stride": [64, 64]},
    "tpu": {"compute_dtype": "float32", "segment_capacity": 32},
}
SCALES = (0.75, 1.0)
CRF = dict(crf_iter_max=10, crf_pos_w=3, crf_pos_xy_std=1, crf_bi_w=4,
           crf_bi_xy_std=67, crf_bi_rgb_std=3)


def _write_snapshot(snap, num_classes):
    """Random flax variables (not PRNGKey(0)'s, so the file is what both
    load) exported to the reference's .pth."""
    os.makedirs(snap)
    emb = build_embedding_model("panoptic_deeplab_10", 8)
    evars = host_init(emb, jax.random.PRNGKey(7),
                      np.zeros((1, *INIT_SAMPLE_HW, 3), np.float32))
    cls = ClassifierHead(num_classes=num_classes, hidden_dim=16)
    cvars = host_init(cls, jax.random.PRNGKey(8),
                      np.zeros((1, 24, 24, 8), np.float32))
    torch_export.save_torch_checkpoint(
        os.path.join(snap, "model-9.pth"),
        {"embedding": evars["params"], "prediction": cvars["params"]},
        {"embedding": evars["batch_stats"],
         "prediction": cvars["batch_stats"]})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("selftrain")
    data = str(root / "data")
    lst = synthetic.write_world(data, 3, shapes=((48, 64), (61, 40)),
                                num_classes=4, segments=6, seed=3)
    synthetic.write_cams(str(root / "cams"), data, lst, num_classes=4,
                         seed=3)
    points = str(root / "points")
    plst = synthetic.write_world(points, 2, shapes=((64, 56),),
                                 num_classes=15, segments=6, seed=4,
                                 points=40)
    _write_snapshot(str(root / "snap"), 4)
    _write_snapshot(str(root / "snap15"), 15)
    args = argparse.Namespace(
        snapshot_dir=str(root / "snap"), save_dir=str(root / "bank"),
        data_dir=data, data_list=lst, cam_dir=str(root / "cams"),
        semantic_memory_dir=str(root / "bank" / "semantic_prototype"),
        **CRF)
    runner.run_prototype(args, load_config(overrides=OVERRIDES),
                         device="cpu")
    return root, args, (points, plst)


def _run(world, name, jfn, fn, overrides=OVERRIDES, data=None,
         snapshot="snap", **kw):
    """Both packages' runner into save dirs jax/<name> and port/<name>;
    returns their args."""
    root, base, _ = world
    out = []
    for pkg, f, load in (("jax", jfn, jload_config), ("port", fn,
                                                      load_config)):
        args = argparse.Namespace(**vars(base))
        args.save_dir = str(root / pkg / name)
        args.snapshot_dir = str(root / snapshot)
        if data is not None:
            args.data_dir, args.data_list = data
        cfg = load(overrides=overrides)
        if pkg == "port":
            f(args, cfg, device="cpu", **kw)
        else:
            f(args, cfg, **kw)
        out.append(args)
    return out


def _assert_pngs_equal(jargs, args, n):
    for sub in ("semantic_gray", "semantic_color"):
        names = sorted(os.listdir(os.path.join(jargs.save_dir, sub)))
        assert len(names) == n
        assert sorted(os.listdir(os.path.join(args.save_dir, sub))) == names
        for name in names:
            want = np.array(PIL.Image.open(
                os.path.join(jargs.save_dir, sub, name)))
            got = np.array(PIL.Image.open(
                os.path.join(args.save_dir, sub, name)))
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{sub}/{name}")


@pytest.mark.parametrize("msc,crf", [(False, True), (True, False),
                                     (True, True)])
def test_knn_inference_matches_jax(world, msc, crf):
    jargs, args = _run(world, f"knn_{msc}_{crf}", jrunner.run_knn_inference,
                       runner.run_knn_inference, msc=msc, crf=crf,
                       scales=SCALES)
    _assert_pngs_equal(jargs, args, 3)


def test_softmax_inference_matches_jax(world):
    """inference_softmax_crf_msc.py, the recipe's last step."""
    jargs, args = _run(world, "softmax", jrunner.run_softmax_inference,
                       runner.run_softmax_inference, msc=True, crf=True,
                       scales=SCALES)
    _assert_pngs_equal(jargs, args, 3)


def test_pseudo_camrw_crf_matches_jax(world):
    jargs, args = _run(world, "camrw", jrunner.run_pseudo_camrw_crf,
                       runner.run_pseudo_camrw_crf)
    _assert_pngs_equal(jargs, args, 3)


def test_pseudo_softmax_matches_jax(world):
    """The recipe's pseudo_softmaxrw_crf.py: scales (1.0,), the walk and
    the CRF."""
    jargs, args = _run(world, "psoftmax", jrunner.run_pseudo_softmax,
                       runner.run_pseudo_softmax, with_crf=True,
                       with_walk=True, scales=(1.0,))
    _assert_pngs_equal(jargs, args, 3)


def test_pseudo_knn_matches_jax(world):
    jargs, args = _run(world, "pknn", jrunner.run_pseudo_knn,
                       runner.run_pseudo_knn, scales=SCALES)
    _assert_pngs_equal(jargs, args, 3)


def test_pseudo_densepose_matches_jax(world):
    """Point labels of 15 classes; the pixels without a point stay
    255."""
    _, _, (points, plst) = world
    over = dict(OVERRIDES, dataset={"num_classes": 15})
    jargs, args = _run(world, "densepose", jrunner.run_pseudo_densepose,
                       runner.run_pseudo_densepose, overrides=over,
                       data=(points, plst), snapshot="snap15")
    _assert_pngs_equal(jargs, args, 2)
    pred = np.array(PIL.Image.open(os.path.join(
        args.save_dir, "semantic_gray", "0000.png")))
    sem = np.array(PIL.Image.open(os.path.join(points, "semantic",
                                               "0000.png")))
    assert ((pred == 255) == (sem == 255)).all()
    assert (pred[sem != 255] < 15).all()
