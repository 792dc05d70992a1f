"""Fixtures of the benchmark's own tests (the CPU at tiny sizes; the
`gpu` tests decide inside a fixture whether there is a card)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

# a tiny form of each configuration: the same code paths at a size the
# CPU holds (ResNet-10, crop 64, batch 2)
TINY_TRAIN = {"network": {"kmeans_num_clusters": [2, 2]},
              "train": {"batch_size": 2, "crop_size": [64, 64]},
              "tpu": {"segment_capacity": 32}}
TINY_BACKBONE = {"panoptic_deeplab_101": "panoptic_deeplab_10",
                 "panoptic_pspnet_101_densepose":
                     "panoptic_pspnet_10_densepose"}


# a cell whose files are under portbench/ but that BENCHMARK.json does
# not list (its throughput swings with the host: PERF.md, Open questions);
# the tests still run its path
UNLISTED = {
    "configs": [{"name": "densepose_point_pspnet101",
                 "file": "portbench/configs/densepose_point_pspnet101.json"}],
    "workloads": [{"name": "densepose_point_train",
                   "config": "densepose_point_pspnet101",
                   "traffic": "densepose_point_train", "chips": 1}]}


@pytest.fixture
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture
def every_cell(bench):
    """BENCHMARK.json's cells and the unlisted ones."""
    return dict(bench, **{k: bench[k] + UNLISTED[k] for k in UNLISTED})


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst.setdefault(k, {}), v)
        else:
            dst[k] = v


def tiny_cell(bench, name, root=ROOT):
    """The cell `name` cut to a CPU size, its limits kept."""
    from portbench import run

    return tiny(run.load_cell(bench, name, root))


def tiny(cell):
    """A loaded cell cut to a CPU size."""
    cell = copy.deepcopy(cell)
    cfg = cell["config"]
    for key in ("overrides", "inference_overrides"):
        if key in cfg:
            net = cfg[key]["network"]
            net["backbone_types"] = TINY_BACKBONE[net["backbone_types"]]
    if cell["traffic"]["driver"] == "train":
        _merge(cfg["overrides"], TINY_TRAIN)
        cell["traffic"]["ring"] = 4
    else:
        inf = cfg["inference_overrides"]
        inf["network"]["kmeans_num_clusters"] = [3, 3]
        inf["test"].update(crop_size=[64, 64], stride=[64, 64])
        cell["traffic"].update(pool=4, crop=64, shapes=[[64, 48], [48, 64]],
                               bank_rows=5000)
    return cell


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
