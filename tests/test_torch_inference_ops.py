"""The inference path's ops and host pieces, port against the JAX package
on the CPU, same numpy inputs from a seed: the KNN majority vote, the
single-group segmentation, the window grid, the host transforms, the
metrics, the colour maps, the evaluation dataset and the runner's input
and output resizes.

Integers exactly equal; the normalized embeddings rtol 1e-5 / atol 1e-6
(one float32 normalization); host arrays (numpy and PIL on both sides)
exactly equal.
"""

import numpy as np
import jax.numpy as jnp
import PIL.Image
import pytest
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.data import datasets as jdatasets
from spml_tpu.data import transforms as jtransforms
from spml_tpu.inference import engine as jengine
from spml_tpu.inference import runner as jrunner
from spml_tpu.ops import common as jcommon
from spml_tpu.ops import kmeans as jkmeans
from spml_tpu.ops import knn as jknn
from spml_tpu.utils import metrics as jmetrics
from spml_tpu.utils import vis as jvis
from spml_tpu_torch.config import load_config
from spml_tpu_torch.data import datasets, transforms
from spml_tpu_torch.inference import engine, runner
from spml_tpu_torch.ops import kmeans, knn
from spml_tpu_torch.utils import metrics, vis


@pytest.mark.parametrize("num_classes", [4, 21])
def test_majority_label_from_topk_matches_jax(num_classes):
    """Labels outside [0, C) and ties (the lower class wins) included."""
    rng = np.random.RandomState(num_classes)
    topk = rng.randint(-1, num_classes + 2, (64, 20)).astype(np.int32)
    topk[0] = [1] * 10 + [0] * 10  # a tie: class 0 wins
    topk[1] = [num_classes + 1] * 20  # no vote in range: class 0
    got = knn.majority_label_from_topk(torch.from_numpy(topk), num_classes)
    want = jknn.majority_label_from_topk(jnp.asarray(topk), num_classes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == 0 and got[1] == 0


@pytest.mark.parametrize("clusters,iters", [((3, 3), 4), ((2, 3), 1)])
def test_segment_batch_single_group_matches_jax(clusters, iters):
    """Two images, the second with an ignored band and the first with a
    few ignored pixels, and a third all ignored (no valid segment)."""
    rng = np.random.RandomState(sum(clusters))
    b, h, w, d = 3, 12, 10, 8
    emb = rng.randn(b, h, w, d).astype(np.float32)
    loc = np.broadcast_to(
        np.asarray(jcommon.generate_location_features(h, w)) - 0.5,
        (b, h, w, 2)).astype(np.float32)
    sem = np.zeros((b, h, w), np.int32)
    sem[0, rng.randint(0, h, 6), rng.randint(0, w, 6)] = 255
    sem[1, 7:, :] = 255
    sem[2] = 255
    jsegs, jemb = jkmeans.segment_batch_single_group(
        jnp.asarray(emb), jnp.asarray(loc), jnp.asarray(sem), clusters,
        iters, 255)
    segs, emb_flat = kmeans.segment_batch_single_group(
        torch.from_numpy(emb), torch.from_numpy(loc), torch.from_numpy(sem),
        clusters, iters, 255)
    np.testing.assert_allclose(emb_flat.numpy(), np.asarray(jemb),
                               rtol=1e-5, atol=1e-6)
    for field in segs._fields:
        np.testing.assert_array_equal(
            getattr(segs, field).numpy(), np.asarray(getattr(jsegs, field)),
            err_msg=field)
    assert not segs.segment_valid[2].any()
    assert segs.segment_valid[0].sum() > 1


def test_patch_ends_and_bucket_dim_match_jax():
    for crop in (16, 32, 33):
        for stride in (8, 16, 32):
            for size in range(1, 100, 3):
                assert engine.bucket_dim(size, crop, stride) == \
                    jengine.bucket_dim(size, crop, stride)
                pad = max(size, crop)
                np.testing.assert_array_equal(
                    engine.patch_ends(pad, crop, stride),
                    jengine.patch_ends(pad, crop, stride))


@pytest.mark.parametrize("shape,new", [((13, 17), (9, 30)),
                                       ((13, 17, 3), (26, 8)),
                                       ((5, 6, 2), (5, 6))])
def test_resize_image_and_nearest_match_jax(shape, new):
    rng = np.random.RandomState(len(shape))
    image = rng.randn(*shape).astype(np.float32)
    label = rng.randint(0, 256, shape[:2]).astype(np.uint8)
    np.testing.assert_array_equal(transforms._resize_image(image, *new),
                                  jtransforms._resize_image(image, *new))
    np.testing.assert_array_equal(transforms._resize_nearest(label, *new),
                                  jtransforms._resize_nearest(label, *new))


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_resize_with_interpolation_matches_jax(method):
    rng = np.random.RandomState(3)
    for shape in ((30, 47, 3), (47, 30), (20, 20, 3)):
        image = rng.rand(*shape).astype(np.float32)
        got = transforms.resize_with_interpolation(image, 24, method)
        want = jtransforms.resize_with_interpolation(image, 24, method)
        # int(ratio * side) may floor the larger side to 23, as in JAX
        assert got.shape == want.shape and max(got.shape[:2]) in (23, 24)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pad_value,mode", [(0.0, "left_top"),
                                            ((1.0, 2.0, 3.0), "left_top"),
                                            (255, "center")])
def test_resize_with_pad_matches_jax(pad_value, mode):
    image = np.random.RandomState(4).rand(7, 5, 3).astype(np.float32)
    for size in ((9, 8), (7, 5), (3, 12)):
        got = transforms.resize_with_pad(image, size, pad_value, mode)
        want = jtransforms.resize_with_pad(image, size, pad_value, mode)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="padding mode"):
        transforms.resize_with_pad(image, (9, 9), 0, "right")


def _label_maps(rng, n=4, h=20, w=24, c=5):
    preds = [rng.randint(0, c + 1, (h, w)) for _ in range(n)]
    gts = [rng.randint(0, c, (h, w)) for _ in range(n)]
    insts = [rng.randint(0, 3, (h, w)) for _ in range(n)]
    for g in gts:
        g[rng.rand(h, w) < 0.1] = 255
    return preds, gts, insts


def test_mean_iou_matches_jax():
    preds, gts, _ = _label_maps(np.random.RandomState(5))
    ours, theirs = metrics.MeanIoU(5), jmetrics.MeanIoU(5)
    for p, g in zip(preds, gts):
        np.testing.assert_array_equal(metrics.confusion_matrix(p, g, 5),
                                      jmetrics.confusion_matrix(p, g, 5))
        ours.update(p, g)
        theirs.update(p, g)
    got, want = ours.result(), theirs.result()
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["class_iou"], want["class_iou"])
    assert got["mean_iou"] == want["mean_iou"]
    assert got["pixel_accuracy"] == want["pixel_accuracy"]


def test_instance_weighted_iou_matches_jax():
    preds, gts, insts = _label_maps(np.random.RandomState(6))
    ours, theirs = metrics.InstanceWeightedIoU(5), \
        jmetrics.InstanceWeightedIoU(5)
    for p, g, i in zip(preds, gts, insts):
        ours.update(p, g, i)
        theirs.update(p, g, i)
    got, want = ours.result(), theirs.result()
    np.testing.assert_array_equal(got["class_iou"], want["class_iou"])
    assert got["mean_iou"] == want["mean_iou"] > 0


def test_color_maps_match_jax(tmp_path):
    """The generated VOC palette, a .mat colormap (0-1 floats) and a
    missing path (the generated palette), and label_to_color with labels
    past the map."""
    np.testing.assert_array_equal(vis.voc_colormap(), jvis.voc_colormap())
    import scipy.io
    mat = tmp_path / "cmap.mat"
    scipy.io.savemat(str(mat), {"colormap": np.random.RandomState(7).rand(
        40, 3)})
    for path in (str(mat), str(tmp_path / "none.mat"), ""):
        np.testing.assert_array_equal(vis.load_color_map(path),
                                      jvis.load_color_map(path))
    label = np.random.RandomState(8).randint(-2, 300, (9, 11))
    for cmap in (None, vis.load_color_map(str(mat))):
        np.testing.assert_array_equal(vis.label_to_color(label, cmap),
                                      jvis.label_to_color(label, cmap))


def _write_list(tmp_path, n=2, with_labels=True):
    rng = np.random.RandomState(9)
    lines = []
    for i in range(n):
        h, w = 10 + i, 14
        PIL.Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
                            ).save(tmp_path / f"im{i}.jpg")
        line = f"im{i}.jpg"
        if with_labels:
            PIL.Image.fromarray(rng.randint(0, 4, (h, w)).astype(
                np.uint8)).save(tmp_path / f"s{i}.png")
            PIL.Image.fromarray(rng.randint(0, 3, (h, w)).astype(
                np.uint8)).save(tmp_path / f"i{i}.png")
            line += f" s{i}.png i{i}.png"
        lines.append(line)
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n\n")
    return str(tmp_path), str(tmp_path / "list.txt")


@pytest.mark.parametrize("with_labels", [True, False])
def test_list_dataset_matches_jax(tmp_path, with_labels):
    """The evaluation form: training=False, size=None."""
    data_dir, data_list = _write_list(tmp_path, with_labels=with_labels)
    assert datasets.read_list(data_dir, data_list) == \
        jdatasets.read_list(data_dir, data_list)
    kw = dict(img_mean=(0.4, 0.5, 0.6), img_std=(0.2, 0.3, 0.4))
    ours = datasets.ListDataset(data_dir, data_list, **kw)
    theirs = jdatasets.ListDataset(data_dir, data_list, **kw)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        got, want = ours[i], theirs[i]
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_runner_resizes_match_jax():
    """_maybe_resize_input at test.image_size 24 (image bilinear, labels
    nearest) and _resize_pred_to back to odd sizes."""
    over = {"test": {"image_size": 24}}
    cfg, jcfg = load_config(overrides=over), jload_config(overrides=over)
    rng = np.random.RandomState(10)
    image = rng.rand(31, 45, 3).astype(np.float32)
    sem = rng.randint(0, 21, (31, 45)).astype(np.int32)
    inst = rng.randint(0, 5, (31, 45)).astype(np.int32)
    got = runner._maybe_resize_input(cfg, image, sem, inst)
    want = jrunner._maybe_resize_input(jcfg, image, sem, inst)
    assert got[0].shape == (16, 24, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pred = rng.randint(0, 21, (16, 24)).astype(np.int32)
    for h, w in ((31, 45), (16, 24), (7, 100), (48, 72)):
        np.testing.assert_array_equal(runner._resize_pred_to(pred, h, w),
                                      jrunner._resize_pred_to(pred, h, w))
