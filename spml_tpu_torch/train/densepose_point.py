"""The DensePose point-supervision training configuration and its
synthetic batch.

The recipe of bashscripts/densepose/train_spml_point.sh:12-46 with
configs/densepose_template.yaml (the reference's
bashscripts/densepose/train_spml_point.sh in twke18/SPML): ResNet-101
PSPNet with colour + location local features, 32-d embeddings, crop 512,
batch 4, 12x12 k-means x10, no memory bank, segment capacity 512, bf16
convolutions; losses sem_ann (SegSort, 6 / 1.0) and img_sim (16 / 0.1),
sem_occ off, and feat_aff (12 / 0.5) configured but inert, as in the
reference (tpu.apply_feat_aff false). The fused loss is on, as
pyscripts/misc/synthetic_densepose_e2e.py:155-187 sets it for this recipe
(the template leaves it at its default): with sem_occ off the step takes
the hard-label SegSort kernels.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_CLASSES = 15  # the DensePose part label space
IGNORE = 255

OVERRIDES = {
    "network": {"backbone_types": "panoptic_pspnet_101_densepose",
                "embedding_dim": 32, "kmeans_num_clusters": [12, 12],
                "kmeans_iterations": 10, "bn_momentum": 3e-4,
                "prediction_types": "segsort"},
    "dataset": {"num_classes": NUM_CLASSES,
                "semantic_ignore_index": IGNORE},
    "train": {"batch_size": 4, "crop_size": [512, 512],
              "memory_bank_size": 0, "base_lr": 3e-3,
              "weight_decay": 5e-4, "warmup_iteration": 100,
              "max_iteration": 45000,
              "sem_ann_loss_types": "segsort",
              "sem_ann_concentration": 6.0, "sem_ann_loss_weight": 1.0,
              "sem_occ_loss_types": "none",
              "img_sim_loss_types": "segsort",
              "img_sim_concentration": 16.0, "img_sim_loss_weight": 0.1,
              "feat_aff_loss_types": "segsort",
              "feat_aff_concentration": 12.0, "feat_aff_loss_weight": 0.5},
    "tpu": {"segment_capacity": 512, "compute_dtype": "bfloat16",
            "use_fused_loss": True, "apply_feat_aff": False},
}

# class ids as DensePose names them: 0 background, 1 torso, 2 right
# hand, 3 left hand, 14 head; both hands share a colour
PART_COLORS = {0: (45, 85, 55), 1: (200, 60, 60), 2: (60, 80, 200),
               3: (60, 80, 200), 14: (150, 70, 180)}


def _figure(yy, xx, cy, cx, s):
    """Part masks of one figure centred at (cy, cx), scale s: torso
    ellipse, head above and to the figure's right, a hand on each side."""
    def disc(y, x, r):
        return (yy - y) ** 2 + (xx - x) ** 2 < r * r
    torso = ((yy - cy) / (28 * s)) ** 2 + ((xx - cx) / (16 * s)) ** 2 < 1
    return ((1, torso), (14, disc(cy - 38 * s, cx - 14 * s, 13 * s)),
            (2, disc(cy - 8 * s, cx - 28 * s, 11 * s)),
            (3, disc(cy - 8 * s, cx + 28 * s, 11 * s)))


def _points(rng, sem, per_class=12, block=2):
    """Point annotation (a copy of synthetic_densepose_e2e.py:54-69): 255
    everywhere except (2 block + 1)^2 blocks around `per_class` sampled
    pixels of each present class, kept inside the class."""
    out = np.full_like(sem, IGNORE)
    for cls in np.unique(sem):
        ys, xs = np.nonzero(sem == cls)
        take = rng.choice(len(ys), min(per_class, len(ys)), replace=False)
        for t in take:
            y, x = ys[t], xs[t]
            sl = (slice(max(0, y - block), y + block + 1),
                  slice(max(0, x - block), x + block + 1))
            out[sl] = np.where(sem[sl] == cls, cls, out[sl])
    return out


def point_batch(batch: int, crop: int, seed: int = 0,
                device="cuda") -> dict:
    """A point-supervised batch: one or two figures per image (instance
    label = figure), images coloured by part plus noise (no channel is
    constant), semantic labels 255 except about 12 5x5 blocks per present
    class, and semantic_tag [B, 256] marking the labelled classes."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:crop, 0:crop].astype(np.float32)
    s = crop / 160.0  # the figures of the 160-pixel synthetic world
    sem = np.zeros((batch, crop, crop), np.int64)
    inst = np.zeros((batch, crop, crop), np.int64)
    img = np.zeros((batch, crop, crop, 3), np.float32)
    tags = np.zeros((batch, 256), np.int64)
    for b in range(batch):
        for f in range(rng.randint(1, 3)):
            cy = rng.uniform(0.35, 0.75) * crop
            cx = rng.uniform(0.25, 0.75) * crop
            for cls, m in _figure(yy, xx, cy, cx, s):
                sem[b][m] = cls
                inst[b][m] = f + 1
        for cls, col in PART_COLORS.items():
            img[b][sem[b] == cls] = np.asarray(col, np.float32) / 255.0
        sem[b] = _points(rng, sem[b])
        present = np.unique(sem[b])
        tags[b, present[present < NUM_CLASSES]] = 1
    img += rng.randn(*img.shape).astype(np.float32) * (16 / 255.0)
    out = {"image": np.clip(img, 0.0, 1.0), "semantic_label": sem,
           "instance_label": inst, "semantic_tag": tags}
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def make_batch(cfg, device="cuda") -> dict:
    """The recipe's batch at cfg's batch size and crop, seed 0."""
    return point_batch(cfg.train.batch_size, cfg.train.crop_size[0],
                       seed=0, device=device)
