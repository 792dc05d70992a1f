"""A synthetic training world on disk: JPEG images, PNG semantic and
instance labels and an 'image semantic instance' list, in the layout the
list datasets read (datasets.read_list).

Semantic labels are blobby: a background of class 0 with a few ellipses of
classes 1..num_classes-1, each inside a ring of 255 (the ignore label,
where a scribble would leave pixels unlabelled). Instance maps are the
Voronoi cells of `segments` random seeds, a stand-in for the HED
segments the reference trains on. The image is a colour per class with a
shade per cell and noise, so it correlates with both maps.
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
                seed: int = 0) -> str:
    """Writes n items under `directory` (images/, semantic/, instance/),
    their shapes (H, W) taken from `shapes` in turn, and list.txt; returns
    the list's path."""
    import PIL.Image

    rng = np.random.default_rng(seed)
    for sub in ("images", "semantic", "instance"):
        os.makedirs(os.path.join(directory, sub), exist_ok=True)
    lines = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        img, sem, inst = _item(rng, h, w, num_classes, segments)
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
