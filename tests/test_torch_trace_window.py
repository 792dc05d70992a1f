"""The profiler window of the port's training drivers (tpu.profile_dir,
profile_start, profile_steps; train/driver.py::TraceWindow) on the CPU,
as the JAX package's tests/test_train_step.py::test_profiler_trace_window
checks its own:

* train_spml with a window of steps 1-2 writes one Chrome trace; a run
  resumed at step 3 with a one-step window at profile_start 1 traces step
  4 (the window counts from the run's first step), and its trace holds
  half the forward convolutions of the two-step one;
* train_classifier over that snapshot writes its trace too;
* a run that ends inside its window still writes the trace;
* an empty profile_dir never starts the profiler, and a traced run's
  steps equal an untraced one's.
"""

import argparse
import json
import os

import pytest
import torch

from spml_tpu_torch.config import load_config
from spml_tpu_torch.data import synthetic
from spml_tpu_torch.train import driver

CONFIG = {
    "network": {"backbone_types": "panoptic_deeplab_10", "embedding_dim": 8,
                "kmeans_num_clusters": [2, 2], "kmeans_iterations": 2},
    "dataset": {"num_classes": 5},
    "train": {"batch_size": 2, "crop_size": [32, 32], "max_iteration": 3,
              "snapshot_step": 2, "tensorboard_step": 100,
              "memory_bank_size": 1, "warmup_iteration": 10},
    "tpu": {"segment_capacity": 32, "compute_dtype": "float32",
            "profile_start": 1, "profile_steps": 2},
    "num_threads": 2,
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("world")
    lst = synthetic.write_world(str(root / "data"), 4,
                                shapes=((40, 48), (48, 40)), num_classes=5,
                                segments=8, seed=3)
    return root, str(root / "data"), lst


def _args(world, snapshot):
    root, data, lst = world
    return argparse.Namespace(data_dir=data, data_list=lst,
                              snapshot_dir=str(root / snapshot))


def _config(profile_dir, **train):
    cfg = load_config(overrides=CONFIG)
    cfg.tpu.profile_dir = str(profile_dir)
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _convolutions(path) -> int:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("name") == "aten::convolution" for e in events)


@pytest.fixture(scope="module")
def stage1(world):
    """Steps 0-2 with a window of steps 1-2 (checkpoints 2 and 3), then
    resumed to step 5 with a window of step 4 alone."""
    root = world[0]
    first = _config(root / "trace1", max_iteration=3)
    driver.train_spml(_args(world, "stage1"), first, device="cpu")
    resumed = _config(root / "trace2", max_iteration=5, resume=True)
    resumed.tpu.profile_steps = 1
    driver.train_spml(_args(world, "stage1"), resumed, device="cpu")
    return root


def test_train_spml_writes_its_window(stage1):
    assert os.listdir(stage1 / "trace1") == ["steps_1-3.pt.trace.json"]
    assert _convolutions(stage1 / "trace1" / "steps_1-3.pt.trace.json") > 0


def test_resumed_run_traces_from_its_start(stage1):
    """The resumed run starts at checkpoint 3: its window is step 4."""
    assert os.listdir(stage1 / "trace2") == ["steps_4-5.pt.trace.json"]
    two = _convolutions(stage1 / "trace1" / "steps_1-3.pt.trace.json")
    one = _convolutions(stage1 / "trace2" / "steps_4-5.pt.trace.json")
    assert two == 2 * one > 0


def test_train_classifier_writes_its_window(stage1, world):
    cfg = _config(stage1 / "trace_cls", max_iteration=3)
    cfg.network.pretrained = str(stage1 / "stage1")
    cfg.network.prediction_types = "softmax_classifier"
    cfg.network.kmeans_iterations = 0
    cfg.network.kmeans_num_clusters = (1, 1)
    driver.train_classifier(_args(world, "stage2"), cfg, device="cpu")
    trace = stage1 / "trace_cls" / "steps_1-3.pt.trace.json"
    assert os.listdir(trace.parent) == [trace.name]
    assert _convolutions(trace) > 0


def test_run_ending_inside_its_window_writes_it(world, tmp_path, capsys):
    cfg = _config(tmp_path / "trace", max_iteration=2)
    cfg.tpu.profile_steps = 5
    driver.train_spml(_args(world, tmp_path / "snap"), cfg, device="cpu")
    assert os.listdir(tmp_path / "trace") == ["steps_1-6.pt.trace.json"]
    assert "profiler trace written to" in capsys.readouterr().out


def test_empty_profile_dir_traces_nothing(world, tmp_path, monkeypatch):
    torch.manual_seed(0)
    traced = driver.train_spml(
        _args(world, tmp_path / "a"), _config(tmp_path / "trace",
                                              max_iteration=2), device="cpu")

    def refuse(*a, **k):
        raise AssertionError("the profiler started")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    plain = driver.train_spml(_args(world, tmp_path / "b"), _config(
        "", max_iteration=2), device="cpu")
    for a, b in zip(traced.emb_model.state_dict().values(),
                    plain.emb_model.state_dict().values()):
        assert torch.equal(a, b)
