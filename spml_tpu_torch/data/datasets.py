"""List datasets and a threaded, prefetching batch loader.

Port of spml_tpu/data/datasets.py (reference in twke18/SPML:
spml/data/datasets/base_dataset.py:15-223 — 'image semantic instance'
list lines, RGB / 255 float32 images normalized by the pixel means and
stds, the mirror -> scale (0.5-1.5) -> crop-with-pad training pipeline;
list_tag_dataset.py:11-219 — the 256-wide tag vector from the uncropped
label, the classifier variant with scale 0.5-2.0, grayscale p .3 and
blur p .5; densepose_dataset.py:11-199 — 15 body parts, left/right
swapped on a horizontal flip).

Every item's draws come from np.random.SeedSequence([seed, idx,
training]), so an item depends only on its index, whatever thread makes
it. The JAX package's fused C++ item (native/dataio) is not ported: the
Python path below is the one its rng stream and outputs are defined by.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Iterator

import numpy as np

from spml_tpu_torch.data import transforms

TAG_WIDTH = 256

# left/right swaps under horizontal flip (densepose_dataset.py:74-76)
DENSEPOSE_FLIP_REMAP = np.arange(256, dtype=np.uint8)
DENSEPOSE_FLIP_REMAP[:15] = [0, 1, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10,
                             13, 12, 14]


def read_list(data_dir: str, data_list: str):
    """(image paths, semantic label paths, instance label paths) of a list
    file; the label lists stay empty for lines with only an image."""
    images, sems, insts = [], [], []
    with open(data_list) as f:
        for line in f:
            line = line.strip("\n")
            if not line:
                continue
            parts = line.split(" ")
            images.append(os.path.join(data_dir, parts[0]))
            if len(parts) >= 3:
                sems.append(os.path.join(data_dir, parts[1]))
                insts.append(os.path.join(data_dir, parts[2]))
    return images, sems, insts


def read_image(path: str) -> np.ndarray:
    """[H, W, 3] float32 RGB in [0, 1]."""
    import PIL.Image
    img = np.array(PIL.Image.open(path).convert(mode="RGB"))
    return img.astype(np.float32) / 255.0


def read_label(path: str) -> np.ndarray:
    """[H, W] uint8 label map (mode L)."""
    import PIL.Image
    return np.array(PIL.Image.open(path).convert(mode="L"))


class ListDataset:
    """Dict of numpy arrays per index: image [H, W, 3] float32 normalized;
    semantic_label, instance_label [H, W] int32 when the list names them;
    semantic_tag [256] int32 for the tag datasets.

    training: mirror (with flip_label_remap on the semantic label), scale
    by U(scale_range), crop to `size` with the image padded by the mean
    and the labels by 255, then the colour augmentations (color_aug).
    Evaluation: at the image's own size (`size` is the training crop).
    """

    flip_label_remap: np.ndarray | None = None
    with_tags = False
    scale_range = (0.5, 1.5)
    color_aug = False

    def __init__(self, data_dir, data_list, img_mean=(0, 0, 0),
                 img_std=(1, 1, 1), size=None, random_crop=False,
                 random_scale=False, random_mirror=False, training=False,
                 seed=0):
        (self.image_paths, self.semantic_label_paths,
         self.instance_label_paths) = read_list(data_dir, data_list)
        self.training = training
        self.img_mean = np.asarray(img_mean, np.float32)
        self.img_std = np.asarray(img_std, np.float32)
        self.size = tuple(size) if size is not None else None
        self.random_crop = random_crop
        self.random_scale = random_scale
        self.random_mirror = random_mirror
        self.seed = seed

    def __len__(self):
        return len(self.image_paths)

    def _load(self, idx):
        image = read_image(self.image_paths[idx])
        sem = (read_label(self.semantic_label_paths[idx])
               if self.semantic_label_paths else None)
        inst = (read_label(self.instance_label_paths[idx])
                if self.instance_label_paths else None)
        return image, sem, inst

    def __getitem__(self, idx):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, idx, int(self.training)]))
        image, sem, inst = self._load(idx)
        tags = None
        if self.with_tags and sem is not None:
            tags = np.zeros((TAG_WIDTH,), np.uint8)
            tags[np.unique(sem)] = 1

        if self.training:
            label = np.stack([sem, inst], axis=2)
            if self.random_mirror and rng.uniform(0, 1.0) >= 0.5:
                image, label = transforms.mirror(image, label)
                if self.flip_label_remap is not None:
                    label[..., 0] = self.flip_label_remap[label[..., 0]]
            if self.random_scale:
                image, label = transforms.random_resize(
                    rng, image, label, *self.scale_range)
            if self.random_crop:
                image, label = transforms.random_crop_with_pad(
                    rng, image, label, self.size, self.img_mean, 255)
            if self.color_aug:
                image = transforms.random_grayscale(rng, image)
                image = transforms.random_gaussian_blur(rng, image)
            sem, inst = label[..., 0], label[..., 1]

        image = (image - self.img_mean) / self.img_std
        out = {"image": image.astype(np.float32)}
        if sem is not None:
            out["semantic_label"] = sem.astype(np.int32)
        if inst is not None:
            out["instance_label"] = inst.astype(np.int32)
        if tags is not None:
            out["semantic_tag"] = tags.astype(np.int32)
        return out


class ListTagDataset(ListDataset):
    """Adds the 256-wide dataset-level tag vector
    (list_tag_dataset.py:75-82)."""
    with_tags = True


class ListTagClassifierDataset(ListTagDataset):
    """Stage-2 classifier training: stronger augmentation
    (list_tag_dataset.py:193-214)."""
    scale_range = (0.5, 2.0)
    color_aug = True


class DenseposeDataset(ListDataset):
    flip_label_remap = DENSEPOSE_FLIP_REMAP


class DenseposeTagDataset(DenseposeDataset):
    with_tags = True


class DenseposeClassifierDataset(DenseposeDataset):
    scale_range = (0.5, 2.0)
    color_aug = True
    with_tags = True


class Loader:
    """Shuffling, prefetching batch iterator over a dataset.

    Yields dicts of numpy arrays stacked to a leading dim of `batch`,
    without end (the train loop runs a fixed number of iterations, like
    the reference's re-initialised iterator at train.py:156-159). The
    index order comes from default_rng(seed) alone; a pool of
    num_workers threads makes the items, `prefetch` batches ahead.
    """

    def __init__(self, dataset, batch: int, shuffle=True, seed=0,
                 num_workers: int = 8, prefetch: int = 4):
        self.dataset = dataset
        self.batch = batch
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch

    def _index_stream(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed)
        while True:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                rng.shuffle(order)
            yield from order

    def __iter__(self):
        pool = concurrent.futures.ThreadPoolExecutor(self.num_workers)
        stream = self._index_stream()

        def make_batch_async():
            idxs = [next(stream) for _ in range(self.batch)]
            return [pool.submit(self.dataset.__getitem__, i) for i in idxs]

        pending = [make_batch_async() for _ in range(self.prefetch)]
        try:
            while True:
                futures = pending.pop(0)
                pending.append(make_batch_async())
                items = [f.result() for f in futures]
                yield {k: np.stack([it[k] for it in items])
                       for k in items[0]}
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
