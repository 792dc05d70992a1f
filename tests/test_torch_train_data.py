"""The port's training data against the JAX package's on the CPU: each
augmentation under the same seeded np.random.Generator, the items of all
six list datasets over several indices with mirror, scale, crop and (for
the classifier datasets) colour augmentation on, and the Loader's batches
and order.

All exact: images bit-equal in float32, labels and tags equal as
integers. The JAX datasets take their Python path (use_native = False,
set on the test's instance): the fused C++ item is within a tolerance of
it, not equal, and the port has only the Python path. The world on disk
has 15 classes, so the DensePose flip remap moves labels.
"""

import numpy as np
import pytest

from spml_tpu.data import datasets as jdatasets
from spml_tpu.data import transforms as jtransforms
from spml_tpu_torch.data import datasets, synthetic, transforms

DATASETS = ["ListDataset", "ListTagDataset", "ListTagClassifierDataset",
            "DenseposeDataset", "DenseposeTagDataset",
            "DenseposeClassifierDataset"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("world")
    lst = synthetic.write_world(str(root), 6, shapes=((40, 48), (48, 40)),
                                num_classes=15, segments=8, seed=1)
    return str(root), lst


def _pair(cls_name, world, seed=3, size=(32, 32)):
    root, lst = world
    kw = dict(img_mean=(0.485, 0.456, 0.406), img_std=(0.229, 0.224, 0.225),
              size=size, random_crop=True, random_scale=True,
              random_mirror=True, training=True, seed=seed)
    theirs = getattr(jdatasets, cls_name)(root, lst, **kw)
    theirs.use_native = False
    return getattr(datasets, cls_name)(root, lst, **kw), theirs


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _image_label(seed=0, h=23, w=17):
    rng = np.random.RandomState(seed)
    image = rng.rand(h, w, 3).astype(np.float32)
    label = rng.randint(0, 5, (h, w, 2)).astype(np.uint8)
    return image, label


@pytest.mark.parametrize("fn", [
    "resize", "random_resize", "mirror", "random_mirror",
    "random_crop_with_pad", "random_grayscale", "random_gaussian_blur"])
def test_augmentation_matches_jax(fn):
    """Five seeds each, so the random branches go both ways; the outputs
    and the generators' states after the call are equal."""
    for seed in range(5):
        image, label = _image_label(seed)
        outs = []
        for mod in (transforms, jtransforms):
            rng = np.random.default_rng(seed)
            if fn == "resize":
                out = mod.resize(image, label, 1.37)
            elif fn == "random_resize":
                out = mod.random_resize(rng, image, label, 0.5, 2.0)
            elif fn == "mirror":
                out = mod.mirror(image, label)
            elif fn == "random_mirror":
                out = mod.random_mirror(rng, image, label)
            elif fn == "random_crop_with_pad":
                out = mod.random_crop_with_pad(rng, image, label, (20, 29),
                                               (0.1, 0.2, 0.3), 255)
            elif fn == "random_grayscale":
                out = (mod.random_grayscale(rng, image, prob=0.5),)
            else:
                out = (mod.random_gaussian_blur(rng, image, prob=0.5),)
            outs.append((out, rng.uniform()))
        (got, got_next), (want, want_next) = outs
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert got_next == want_next


@pytest.mark.parametrize("cls_name", DATASETS)
def test_dataset_items_match_jax(cls_name, world):
    ours, theirs = _pair(cls_name, world)
    assert len(ours) == len(theirs) == 6
    for idx in range(6):
        _assert_items_equal(ours[idx], theirs[idx])


def test_densepose_flip_remap_applies(world):
    """The same draws give the same crop: where an item was mirrored, the
    DensePose item's semantic label is the remapped plain one, and at
    least one of the six items was mirrored with a part label that
    moves."""
    plain, _ = _pair("ListDataset", world)
    dense, _ = _pair("DenseposeDataset", world)
    moved = 0
    for idx in range(6):
        a, b = plain[idx], dense[idx]
        np.testing.assert_array_equal(a["image"], b["image"])
        if not np.array_equal(a["semantic_label"], b["semantic_label"]):
            np.testing.assert_array_equal(
                datasets.DENSEPOSE_FLIP_REMAP[a["semantic_label"]],
                b["semantic_label"])
            moved += 1
    assert moved > 0


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_match_jax(shuffle, world):
    """Four batches of 4 over 6 items (so the index stream wraps into a
    second shuffled epoch): the same items in the same order."""
    ours, theirs = _pair("ListTagDataset", world, seed=5)
    a = iter(datasets.Loader(ours, 4, shuffle=shuffle, seed=7,
                             num_workers=3, prefetch=2))
    b = iter(jdatasets.Loader(theirs, 4, shuffle=shuffle, seed=7,
                              num_workers=3, prefetch=2))
    try:
        for _ in range(4):
            _assert_items_equal(next(a), next(b))
    finally:
        a.close()
        b.close()
