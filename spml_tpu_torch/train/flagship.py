"""The flagship training configuration and its synthetic batch.

The configuration `bench.py` builds (bench.py:110-133; the reference's VOC
scribble recipe, bashscripts/voc12/train_spml_scribble.sh in twke18/SPML):
ResNet-101 DeepLab at output stride 8, 64-d embeddings, crop 512, batch 8,
6x6 k-means x10, segment capacity 256, memory bank 2, sem_ann + sem_occ +
img_sim with the fused joint loss, bf16 convolutions.
"""

from __future__ import annotations

import numpy as np
import torch

OVERRIDES = {
    "network": {"backbone_types": "panoptic_deeplab_101",
                "embedding_dim": 64, "kmeans_num_clusters": [6, 6],
                "kmeans_iterations": 10},
    "dataset": {"num_classes": 21},
    "train": {"batch_size": 8, "crop_size": [512, 512],
              "memory_bank_size": 2, "max_iteration": 30000,
              "warmup_iteration": 100, "base_lr": 3e-3,
              "sem_ann_concentration": 6.0, "sem_occ_concentration": 12.0,
              "img_sim_concentration": 16.0, "sem_ann_loss_weight": 1.0,
              "sem_occ_loss_weight": 0.5, "img_sim_loss_weight": 0.1},
    "tpu": {"segment_capacity": 256, "compute_dtype": "bfloat16",
            "use_fused_loss": True},
}


def blobby_batch(batch: int, crop: int, num_classes: int, seed: int = 0,
                 ignore: int = 255, device="cuda") -> dict:
    """A few labelled discs per image on a background class, a few ignore
    pixels, dataset-level tags; images correlated with the labels. Fills
    ~17-20% of the prototype capacity, like real scribble data."""
    rng = np.random.RandomState(seed)
    sem = np.zeros((batch, crop, crop), np.int64)
    inst = np.zeros((batch, crop, crop), np.int64)
    img = rng.rand(batch, crop, crop, 3).astype(np.float32) * 0.1
    yy, xx = np.mgrid[0:crop, 0:crop]
    for b in range(batch):
        for k in range(4):
            cy, cx = rng.randint(0, crop, 2)
            r = rng.randint(max(crop // 20, 1), max(crop // 6, 2))
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            sem[b][m] = rng.randint(1, num_classes)
            inst[b][m] = k + 1
            img[b][m] += rng.rand(3).astype(np.float32)
        iy, ix = rng.randint(0, crop, 50), rng.randint(0, crop, 50)
        sem[b, iy, ix] = ignore
    tags = np.zeros((batch, 256), np.int64)
    for b in range(batch):
        u = np.unique(sem[b])
        tags[b, u[u < 256]] = 1
    out = {"image": np.clip(img, 0, 1), "semantic_label": sem,
           "instance_label": inst, "semantic_tag": tags}
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def make_batch(cfg, device="cuda") -> dict:
    """The recipe's batch at cfg's batch size, crop and classes, seed 0."""
    return blobby_batch(cfg.train.batch_size, cfg.train.crop_size[0],
                        cfg.dataset.num_classes, device=device)
