"""List datasets, in their evaluation form.

Port of spml_tpu/data/datasets.py:45-206 (reference:
spml/data/datasets/base_dataset.py:15-223 in twke18/SPML): 'image
semantic instance' list lines, RGB / 255 float32 images normalized by
the pixel means and stds. Only the evaluation form at each image's own
size is ported (training=False, size=None); the training augmentations,
the tag and DensePose datasets and the loader come with the port of
the training loop.
"""

from __future__ import annotations

import os

import numpy as np


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
    """Evaluation dataset: dict of numpy arrays per index (image [H, W, 3]
    float32 normalized, at its own size; semantic_label, instance_label
    int32 when the list names them)."""

    def __init__(self, data_dir, data_list, img_mean=(0, 0, 0),
                 img_std=(1, 1, 1), training=False):
        if training:
            raise NotImplementedError(
                "ListDataset(training=True): the training augmentations "
                "are not ported yet")
        (self.image_paths, self.semantic_label_paths,
         self.instance_label_paths) = read_list(data_dir, data_list)
        self.img_mean = np.asarray(img_mean, np.float32)
        self.img_std = np.asarray(img_std, np.float32)

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx):
        image = read_image(self.image_paths[idx])
        sem = (read_label(self.semantic_label_paths[idx])
               if self.semantic_label_paths else None)
        inst = (read_label(self.instance_label_paths[idx])
                if self.instance_label_paths else None)
        image = (image - self.img_mean) / self.img_std
        out = {"image": image.astype(np.float32)}
        if sem is not None:
            out["semantic_label"] = sem.astype(np.int32)
        if inst is not None:
            out["instance_label"] = inst.astype(np.int32)
        return out
