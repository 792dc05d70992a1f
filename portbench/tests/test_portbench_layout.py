"""BENCHMARK.json against the contract's form, and every configuration,
cell and metric found by its name in files of its own."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import run
from portbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_limits(bench):
    assert set(bench) == KEYS
    assert 1 <= bench["run_seconds"] <= 51
    assert "portbench" in bench["paths"] and len(bench["paths"]) <= 16
    # a full check of 24 cells fits its 43200 seconds
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.append(w["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert [m["name"] for m in bench["end_to_end"]].count("setup_s") == 1


def test_every_cell_reports_what_its_metrics_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for name in cells:
        e2e = [m["name"] for m in bench["end_to_end"]
               if run.applies(m, name)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in bench["per_layer"] if run.applies(m, name, e2e)]
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (name, m["name"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "per_layer"])
def test_each_entry_is_a_file_found_by_name(bench, kind):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for entry in bench[kind]:
        if kind == "configs":
            cfg = run.load_json(ROOT / entry["file"])
            assert cfg["name"] == entry["name"]
            assert cfg["reduced"] == entry["reduced"]
            assert cfg["source"] == entry["source"]
        elif kind == "workloads":
            cell = run.load_cell(bench, entry["name"], ROOT)
            assert cell["traffic"]["driver"] in ("train", "knn_infer")
            assert cell["limits"], "each cell has its limits"
        else:
            mod = run.load_metric(entry["name"], ROOT)
            assert entry["moves"] in e2e and callable(mod.read)


def test_layers_are_named_alike(bench):
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["moves"])
    assert "device" in layers
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer.split(" (")[0] in perf, layer


def test_a_new_cell_is_files_alone(bench, tmp_path):
    """A cell added by a traffic file and an entry: found and run (on the
    CPU, at a tiny size) without an edit to any file there is."""
    from portbench.tests.conftest import tiny_cell

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = run.load_json(ROOT / "portbench/workloads/"
                            "voc_scribble_train.json")
    traffic["params"] = {"discs": 2, "radius_div": [10, 4],
                         "ignore_pixels": 10}
    (tmp_path / "portbench/workloads/voc_big_discs.json").write_text(
        json.dumps(traffic))
    new = dict(bench, workloads=bench["workloads"] + [
        {"name": "voc_big_discs_train", "config": "voc_scribble_deeplab101",
         "traffic": "voc_big_discs", "chips": 1, "why": "bigger discs"}])
    cell = tiny_cell(new, "voc_big_discs_train", tmp_path)
    assert cell["traffic"]["params"]["discs"] == 2
    import time

    import torch

    from portbench.drivers import train
    got = train.run(cell, 7, 0.0, False, torch.device("cpu"),
                    time.perf_counter())
    assert got["attempted"] >= 1 and got["failed"] == 0
