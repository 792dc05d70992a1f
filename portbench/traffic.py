"""The benchmark's input generators, frozen copies of the program's.

Each takes its parameters from a traffic file (portbench/workloads/) and
its randomness from the run's --seed alone, so the same seed gives the
same inputs and later edits of the program change none of them.

* blobby_batch: spml_tpu_torch/train/flagship.py:38-63 (blobby_batch),
  with the disc count, radii and ignore pixels as parameters;
* point_batch, _figure, _points, PART_COLORS:
  spml_tpu_torch/train/densepose_point.py:48-109;
* inference_images: chip_smoke.py:4364-4379 (inference_images);
* make_bank: chip_smoke.py:4382-4400 (make_bank), its rows all random
  unit vectors with random labels, drawn on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def rng(seed: int, *stream: int) -> np.random.RandomState:
    """A numpy generator of (seed, stream...): any whole seed, however
    large."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *stream])
    return np.random.RandomState(ss.generate_state(1)[0])


def torch_seed(seed: int, *stream: int) -> int:
    """A torch.Generator seed of (seed, stream...)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *stream])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def blobby_batch(r: np.random.RandomState, batch: int, crop: int,
                 num_classes: int, discs: int = 4, radius_div=(20, 6),
                 ignore_pixels: int = 50, ignore: int = 255) -> dict:
    """A few labelled discs per image on a background class, a few ignore
    pixels, dataset-level tags [B, 256]; images correlated with the
    labels. numpy arrays."""
    sem = np.zeros((batch, crop, crop), np.int64)
    inst = np.zeros((batch, crop, crop), np.int64)
    img = r.rand(batch, crop, crop, 3).astype(np.float32) * 0.1
    yy, xx = np.mgrid[0:crop, 0:crop]
    lo, hi = max(crop // radius_div[0], 1), max(crop // radius_div[1], 2)
    for b in range(batch):
        for k in range(discs):
            cy, cx = r.randint(0, crop, 2)
            rad = r.randint(lo, hi)
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < rad * rad
            sem[b][m] = r.randint(1, num_classes)
            inst[b][m] = k + 1
            img[b][m] += r.rand(3).astype(np.float32)
        iy, ix = r.randint(0, crop, ignore_pixels), r.randint(
            0, crop, ignore_pixels)
        sem[b, iy, ix] = ignore
    tags = np.zeros((batch, 256), np.int64)
    for b in range(batch):
        u = np.unique(sem[b])
        tags[b, u[u < 256]] = 1
    return {"image": np.clip(img, 0, 1), "semantic_label": sem,
            "instance_label": inst, "semantic_tag": tags}


# DensePose part ids: 0 background, 1 torso, 2 right hand, 3 left hand,
# 14 head; both hands share a colour
PART_COLORS = {0: (45, 85, 55), 1: (200, 60, 60), 2: (60, 80, 200),
               3: (60, 80, 200), 14: (150, 70, 180)}


def _figure(yy, xx, cy, cx, s):
    """Part masks of one figure centred at (cy, cx), scale s."""
    def disc(y, x, rad):
        return (yy - y) ** 2 + (xx - x) ** 2 < rad * rad
    torso = ((yy - cy) / (28 * s)) ** 2 + ((xx - cx) / (16 * s)) ** 2 < 1
    return ((1, torso), (14, disc(cy - 38 * s, cx - 14 * s, 13 * s)),
            (2, disc(cy - 8 * s, cx - 28 * s, 11 * s)),
            (3, disc(cy - 8 * s, cx + 28 * s, 11 * s)))


def _points(r, sem, per_class, block, ignore):
    """ignore everywhere except (2 block + 1)^2 blocks around `per_class`
    sampled pixels of each present class, kept inside the class."""
    out = np.full_like(sem, ignore)
    for cls in np.unique(sem):
        ys, xs = np.nonzero(sem == cls)
        take = r.choice(len(ys), min(per_class, len(ys)), replace=False)
        for t in take:
            y, x = ys[t], xs[t]
            sl = (slice(max(0, y - block), y + block + 1),
                  slice(max(0, x - block), x + block + 1))
            out[sl] = np.where(sem[sl] == cls, cls, out[sl])
    return out


def point_batch(r: np.random.RandomState, batch: int, crop: int,
                num_classes: int, per_class: int = 12, block: int = 2,
                ignore: int = 255) -> dict:
    """A point-supervised batch: one or two figures per image (instance =
    figure), images coloured by part plus noise, semantic labels ignore
    but for about `per_class` blocks a present class, tags [B, 256] of
    the labelled classes. numpy arrays."""
    yy, xx = np.mgrid[0:crop, 0:crop].astype(np.float32)
    s = crop / 160.0
    sem = np.zeros((batch, crop, crop), np.int64)
    inst = np.zeros((batch, crop, crop), np.int64)
    img = np.zeros((batch, crop, crop, 3), np.float32)
    tags = np.zeros((batch, 256), np.int64)
    for b in range(batch):
        for f in range(r.randint(1, 3)):
            cy = r.uniform(0.35, 0.75) * crop
            cx = r.uniform(0.25, 0.75) * crop
            for cls, m in _figure(yy, xx, cy, cx, s):
                sem[b][m] = cls
                inst[b][m] = f + 1
        for cls, col in PART_COLORS.items():
            img[b][sem[b] == cls] = np.asarray(col, np.float32) / 255.0
        sem[b] = _points(r, sem[b], per_class, block, ignore)
        present = np.unique(sem[b])
        tags[b, present[present < num_classes]] = 1
    img += r.randn(*img.shape).astype(np.float32) * (16 / 255.0)
    return {"image": np.clip(img, 0.0, 1.0), "semantic_label": sem,
            "instance_label": inst, "semantic_tag": tags}


GENERATORS = {"blobby": blobby_batch, "points": point_batch}


def train_ring(traffic: dict, seed: int, batch: int, crop: int,
               num_classes: int, device) -> list[dict]:
    """traffic["ring"] distinct batches of the traffic's generator, batch
    i from the stream (seed, i), as tensors on `device`: images float32,
    labels uint8 (as a loader hands them over), tags int64."""
    make = GENERATORS[traffic["generator"]]
    params = traffic.get("params", {})
    ring = []
    for i in range(traffic["ring"]):
        out = make(rng(seed, i), batch, crop, num_classes, **params)
        for key in ("semantic_label", "instance_label"):
            out[key] = out[key].astype(np.uint8)
        ring.append({k: torch.as_tensor(v).to(device) for k, v in out.items()})
    return ring


def inference_images(traffic: dict, seed: int, num_classes: int, means,
                     stds) -> list[np.ndarray]:
    """traffic["pool"] normalized images of the blobby generator at
    traffic["crop"], cut to traffic["shapes"] in turn."""
    r = rng(seed, 0)
    n, crop = traffic["pool"], traffic["crop"]
    batch = blobby_batch(r, n, crop, num_classes,
                         **traffic.get("params", {}))
    mean, std = np.asarray(means, np.float32), np.asarray(stds, np.float32)
    out = []
    for i in range(n):
        h, w = traffic["shapes"][i % len(traffic["shapes"])]
        img = batch["image"][i, :h, :w]
        out.append(((img - mean) / std).astype(np.float32))
    return out


def make_bank(seed: int, rows: int, dim: int, num_classes: int, device):
    """(prototypes [rows, dim] float32 unit vectors, labels [rows] in [0,
    num_classes), valid [rows] all True), drawn on the device."""
    gen = torch.Generator(device).manual_seed(torch_seed(seed, 1))
    p = torch.randn(rows, dim, device=device, generator=gen)
    p /= p.norm(dim=1, keepdim=True)
    labels = torch.randint(0, num_classes, (rows,), device=device,
                           generator=gen)
    return p, labels, torch.ones(rows, dtype=torch.bool, device=device)
