"""The check that decides `correct`, driven through the rest of a run on
the CPU at a tiny size (the look for a card skipped), sound and with the
timed path broken underneath: each fault comes out not correct."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import faults, run
from portbench.drivers import knn_infer, train
from portbench.tests.conftest import tiny_cell

CPU = torch.device("cpu")
CELLS = {"voc_scribble_train": train, "densepose_point_train": train,
         "voc_scribble_knn_infer": knn_infer}
TRAIN_FAULTS = ["state_unchanged", "window_unchanged", "half_batch"]
FAULTS = {"voc_scribble_train": TRAIN_FAULTS,
          "densepose_point_train": TRAIN_FAULTS,
          "voc_scribble_knn_infer": ["answer_altered"]}


def _run(bench, name, seed=11):
    cell = tiny_cell(bench, name)
    got = CELLS[name].run(cell, seed, 0.0, False, CPU, time.perf_counter())
    ok, checks = run.judge(got["numbers"], cell["limits"])
    return ok and got["failed"] == 0, got["numbers"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(every_cell, name):
    ok, numbers = _run(every_cell, name)
    assert ok, numbers


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(FAULTS)
                                        for f in FAULTS[n]])
def test_fault_is_not_correct(every_cell, name, fault):
    with faults.FAULTS[fault]():
        ok, numbers = _run(every_cell, name)
    assert not ok, numbers


def test_judge_needs_every_limit():
    ok, out = run.judge({"a": 0.1, "b": 0.0}, {"a": 0.2})
    assert not ok and out["b"]["limit"] is None
    assert run.judge({"a": float("nan")}, {"a": 1.0})[0] is False
    assert run.judge({"a": 0.2}, {"a": 0.2})[0] is True
