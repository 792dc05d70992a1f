"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program either: top-level module
names compared whole (spml_tpu_torch begins with spml_tpu)."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.conftest import ROOT

PKG = ROOT / "portbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_no_forbidden_import(path):
    tops = set(_imports(PKG / path))
    forbidden = set(run.FORBIDDEN)
    if path.startswith("reference/"):
        forbidden.add("spml_tpu_torch")
    assert not tops & forbidden


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "spml_tpu_torch_fake", sys)
    assert "spml_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "spml_tpu.fake", sys)
    assert run.loaded_forbidden() == ["spml_tpu"]


def test_the_harness_loads_no_jax():
    code = ("import sys; import portbench.run, portbench.control, "
            "portbench.drivers.train, portbench.drivers.knn_infer; "
            "import spml_tpu_torch.train.step, "
            "spml_tpu_torch.inference.engine, spml_tpu_torch.cli; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"{set(run.FORBIDDEN)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    """Without a CUDA card a run fails and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "voc_scribble_train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
