"""The generators repeat per seed and differ across seeds."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import traffic

SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)
TRAIN = {"blobby": {"generator": "blobby", "ring": 2,
                    "params": {"discs": 4, "radius_div": [20, 6],
                               "ignore_pixels": 50}},
         "points": {"generator": "points", "ring": 2,
                    "params": {"per_class": 12, "block": 2}}}


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("gen", sorted(TRAIN))
@pytest.mark.parametrize("seed", SEEDS)
def test_train_ring_repeats_and_differs(gen, seed):
    cpu = torch.device("cpu")
    one = traffic.train_ring(TRAIN[gen], seed, 2, 64, 15, cpu)
    two = traffic.train_ring(TRAIN[gen], seed, 2, 64, 15, cpu)
    other = traffic.train_ring(TRAIN[gen], seed + 1, 2, 64, 15, cpu)
    assert all(_same(a, b) for a, b in zip(one, two))
    assert not _same(one[0], other[0])
    assert not _same(one[0], one[1])  # the batches of a ring differ
    for b in one:
        assert b["image"].shape == (2, 64, 64, 3)
        lab = b["semantic_label"]
        assert ((lab < 15) | (lab == 255)).all()


def test_point_batch_labels_few_pixels():
    b = traffic.point_batch(traffic.rng(3), 4, 512, 15)
    labelled = (b["semantic_label"] != 255).mean()
    assert 0.0005 < labelled < 0.02


@pytest.mark.parametrize("seed", SEEDS)
def test_inference_images_and_bank(seed):
    t = {"pool": 4, "crop": 64, "shapes": [[64, 48], [48, 64]],
         "params": {"discs": 4, "radius_div": [20, 6], "ignore_pixels": 50}}
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    one = traffic.inference_images(t, seed, 21, mean, std)
    two = traffic.inference_images(t, seed, 21, mean, std)
    other = traffic.inference_images(t, seed + 1, 21, mean, std)
    assert [im.shape[:2] for im in one] == [(64, 48), (48, 64)] * 2
    assert all(np.array_equal(a, b) for a, b in zip(one, two))
    assert not np.array_equal(one[0], other[0])
    cpu = torch.device("cpu")
    p, lab, valid = traffic.make_bank(seed, 1000, 64, 21, cpu)
    q, _, _ = traffic.make_bank(seed, 1000, 64, 21, cpu)
    r, _, _ = traffic.make_bank(seed + 1, 1000, 64, 21, cpu)
    assert torch.equal(p, q) and not torch.equal(p, r)
    assert torch.allclose(p.norm(dim=1), torch.ones(1000), atol=1e-5)
    assert lab.min() >= 0 and lab.max() < 21 and valid.all()
