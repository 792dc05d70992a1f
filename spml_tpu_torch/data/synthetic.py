"""A synthetic training world on disk: JPEG images, PNG semantic and
instance labels and an 'image semantic instance' list, in the layout the
list datasets read (datasets.read_list).

Semantic labels are blobby: a background of class 0 with a few ellipses of
classes 1..num_classes-1, each inside a ring of 255 (the ignore label,
where a scribble would leave pixels unlabelled). Instance maps are the
Voronoi cells of `segments` random seeds, a stand-in for the HED
segments the reference trains on. The image is a colour per class with a
shade per cell and noise, so it correlates with both maps.

A point-label world (points=N) keeps N labelled pixels of each semantic
map and 255 elsewhere, as DensePose's point annotations do. write_cams
adds SEAM-style class activation maps of a world's images.
"""

from __future__ import annotations

import os

import numpy as np


def _item(rng, h, w, num_classes, segments):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sem = np.zeros((h, w), np.uint8)
    for _ in range(rng.integers(2, 5)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(0.1, 0.35) * h, rng.uniform(0.1, 0.35) * w
        r = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        sem[r < 1.3] = 255
        sem[r < 0.8] = rng.integers(1, num_classes)
    seeds = rng.uniform(0, 1, (segments, 2)) * np.float32([h, w])
    d = ((yy[..., None] - seeds[:, 0]) ** 2
         + (xx[..., None] - seeds[:, 1]) ** 2)
    inst = np.argmin(d, axis=-1).astype(np.uint8)
    palette = rng.uniform(0, 255, (256, 3)).astype(np.float32)
    shade = rng.uniform(-30, 30, segments).astype(np.float32)
    img = (palette[sem] + shade[inst][..., None]
           + rng.normal(0, 8, (h, w, 3)).astype(np.float32))
    return np.clip(img, 0, 255).astype(np.uint8), sem, inst


def write_world(directory: str, n: int, shapes=((375, 500), (500, 375)),
                num_classes: int = 21, segments: int = 30,
                seed: int = 0, points: int | None = None) -> str:
    """Writes n items under `directory` (images/, semantic/, instance/),
    their shapes (H, W) taken from `shapes` in turn, and list.txt; returns
    the list's path. With `points`, each semantic map keeps the labels of
    `points` random pixels (those of the map's 255 rings stay 255) and is
    255 elsewhere."""
    import PIL.Image

    rng = np.random.default_rng(seed)
    for sub in ("images", "semantic", "instance"):
        os.makedirs(os.path.join(directory, sub), exist_ok=True)
    lines = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        img, sem, inst = _item(rng, h, w, num_classes, segments)
        if points is not None:
            keep = np.zeros(h * w, bool)
            keep[rng.choice(h * w, points, replace=False)] = True
            sem = np.where(keep.reshape(h, w), sem, 255).astype(np.uint8)
        names = (f"images/{i:04d}.jpg", f"semantic/{i:04d}.png",
                 f"instance/{i:04d}.png")
        PIL.Image.fromarray(img, mode="RGB").save(
            os.path.join(directory, names[0]), quality=90)
        PIL.Image.fromarray(sem, mode="L").save(
            os.path.join(directory, names[1]))
        PIL.Image.fromarray(inst, mode="L").save(
            os.path.join(directory, names[2]))
        lines.append(" ".join(names))
    path = os.path.join(directory, "list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_cams(directory: str, data_dir: str, data_list: str,
               num_classes: int = 21, seed: int = 0) -> None:
    """SEAM-style CAMs of a world's images, one .npy of a pickled dict
    {class - 1: [H, W] float32 in [0, 1]} an image, named as the image
    with .npy (what run_pseudo_camrw_crf reads): for each class of the
    semantic map but background, its mask blurred, scaled by a random
    peak and noised, from `seed`."""
    from scipy import ndimage

    from spml_tpu_torch.data import datasets

    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    images, labels, _ = datasets.read_list(data_dir, data_list)
    for image, label in zip(images, labels):
        sem = datasets.read_label(label)
        cam = {}
        for k in np.unique(sem):
            if 1 <= k < num_classes:
                act = ndimage.gaussian_filter((sem == k).astype(np.float32),
                                              sigma=6.0)
                act = act * rng.uniform(0.6, 1.0) + rng.uniform(
                    0, 0.05, sem.shape)
                cam[int(k) - 1] = np.clip(act, 0, 1).astype(np.float32)
        base = os.path.splitext(os.path.basename(image))[0]
        np.save(os.path.join(directory, base + ".npy"), cam,
                allow_pickle=True)
