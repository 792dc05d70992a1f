"""The controls (portbench/control.py): the reference one step below the
configuration's precision, put in the program's place, reads above the
program at a tiny size; on the card too (the `gpu` tests)."""

from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench.tests.conftest import tiny_cell

ARMS = {"voc_scribble_train": "reference_fp8",
        "densepose_point_train": "reference_fp8",
        "voc_scribble_knn_infer": "reference_fp8_tf32"}
KEY = {"voc_scribble_train": ["grad_gap", "step_gap_window"],
       "densepose_point_train": ["grad_gap", "step_gap_window"],
       "voc_scribble_knn_infer": ["stitched_max_gap"]}


def _separates(bench, name, device):
    cell = tiny_cell(bench, name)
    if cell["traffic"]["driver"] == "train":
        prog, kept = control.program(cell, 5, 0.0, device, keep=True)
        low = control.train_control(cell, 5, ARMS[name], device,
                                    dict(kept, seconds=0.0))
    else:
        prog = control.program(cell, 5, 0.0, device)
        low = control.infer_control(cell, 5, ARMS[name], device)
    for key in KEY[name]:
        assert low[key] > 3 * prog[key], (key, prog, low)
        assert low[key] > cell["limits"][key], (key, low, cell["limits"])


@pytest.mark.parametrize("name", sorted(ARMS))
def test_control_separates_on_the_cpu(every_cell, name):
    _separates(every_cell, name, torch.device("cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ARMS))
def test_control_separates_on_the_card(every_cell, name, cuda_device):
    _separates(every_cell, name, cuda_device)
