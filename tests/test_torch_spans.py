"""The port's own spans (spml_tpu_torch/utils/spans.py) on the CPU, at a
tiny size: panoptic_deeplab_10 at dim 8, crop 32, batch 2, the dense
losses.

* With no profiler running, a train step and a predict_semantic build no
  record_function.
* Under a CPU profile one train step holds one each of the six
  spml.train.* spans, the five phases inside spml.train.step, in order
  and not overlapping; one predict_semantic holds spml.infer.image
  around one spml.infer.upload.
* A profiled step's losses and updated weights equal an unprofiled
  step's bit for bit.
* tools/profile_step.py::by_span on a synthetic event list: a gap closed
  by a kernel launched inside a span is that span's, a launch outside
  every span goes to "outside any span", and nested spans count a kernel
  once.
"""

import json

import numpy as np
import pytest
import torch

from spml_tpu_torch.config import load_config
from spml_tpu_torch.inference import engine as engine_lib
from spml_tpu_torch.models.embeddings import build_embedding_model
from spml_tpu_torch.tools import profile_step
from spml_tpu_torch.train import step as step_lib

TRAIN = {
    "network": {"backbone_types": "panoptic_deeplab_10", "embedding_dim": 8,
                "kmeans_num_clusters": [2, 2], "kmeans_iterations": 2},
    "dataset": {"num_classes": 4},
    "train": {"batch_size": 2, "crop_size": [32, 32], "memory_bank_size": 1,
              "warmup_iteration": 10},
    "tpu": {"segment_capacity": 16, "compute_dtype": "float32",
            "use_fused_loss": False},
}
INFER = {
    "network": {"backbone_types": "panoptic_deeplab_10", "embedding_dim": 8,
                "kmeans_num_clusters": [2, 2], "kmeans_iterations": 2},
    "dataset": {"num_classes": 4},
    "test": {"crop_size": [32, 32], "stride": [16, 16], "image_size": 0},
    "tpu": {"compute_dtype": "float32"},
}
PHASES = ("spml.train.forward", "spml.train.kmeans", "spml.train.losses",
          "spml.train.backward", "spml.train.update")
STAGES = ("spml.infer.upload",)


def _batch():
    rng = np.random.RandomState(3)
    return {
        "image": torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32)),
        "semantic_label": torch.from_numpy(
            rng.choice([0, 1, 2, 3, 255], (2, 32, 32)).astype(np.uint8)),
        "instance_label": torch.from_numpy(
            rng.randint(0, 3, (2, 32, 32)).astype(np.uint8)),
        "semantic_tag": torch.from_numpy(
            (rng.rand(2, 256) > 0.6).astype(np.int32)),
    }


def _trainer():
    cfg = load_config(overrides=TRAIN)
    batch = _batch()
    state = step_lib.init_state(cfg, 0, batch["image"], device="cpu")
    return state, step_lib.make_train_step(cfg), batch


@pytest.fixture(scope="module")
def engine():
    cfg = load_config(overrides=INFER)
    torch.manual_seed(0)
    eng = engine_lib.InferenceEngine(
        cfg, build_embedding_model("panoptic_deeplab_10", 8), device="cpu")
    rng = np.random.RandomState(1)
    protos = rng.randn(30, 8).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    bank = (protos, rng.randint(0, 4, 30).astype(np.int32), np.ones(30, bool))
    return eng, rng.randn(30, 28, 3).astype(np.float32), bank


def _spans(prof, tmp_path) -> list:
    """[(start, end, name)] of the profile's spml.* spans, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("spml."))


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _tiled(spans, root, parts):
    """One `root` span holding one each of `parts`, in that order, not
    overlapping; nothing else."""
    assert [n for _, _, n in spans] == [root, *parts]
    (s0, e0, _), inner = spans[0], spans[1:]
    for (s, e, _), nxt in zip(inner, inner[1:] + [(e0, e0, None)]):
        assert s0 <= s <= e <= nxt[0] <= e0


def test_no_record_function_without_a_profiler(engine, monkeypatch):
    built = []
    real = torch.profiler.record_function

    def counted(name, *args):
        built.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    state, train_step, batch = _trainer()
    train_step(state, batch)
    eng, image, bank = engine
    eng.predict_semantic(image, *bank)
    assert built == []
    with _cpu_profile():  # the counter sees the spans a profile takes
        eng.predict_semantic(image, *bank)
    assert built == ["spml.infer.image", *STAGES]


def test_train_step_spans_tile_the_step(tmp_path):
    state, train_step, batch = _trainer()
    train_step(state, batch)  # the first step outside the profile
    with _cpu_profile() as prof:
        train_step(state, batch)
    _tiled(_spans(prof, tmp_path), "spml.train.step", PHASES)


def test_predict_semantic_spans(engine, tmp_path):
    eng, image, bank = engine
    with _cpu_profile() as prof:
        eng.predict_semantic(image, *bank)
    _tiled(_spans(prof, tmp_path), "spml.infer.image", STAGES)


def test_profiled_step_equals_plain_step():
    (a, step_a, batch), (b, step_b, _) = _trainer(), _trainer()
    with _cpu_profile():
        a, ma = step_a(a, batch)
    b, mb = step_b(b, batch)
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(torch.as_tensor(ma[k]), torch.as_tensor(mb[k])), k
    for (n, pa), pb in zip(step_lib._named_params(a),
                           (p for _, p in step_lib._named_params(b))):
        assert torch.equal(pa, pb), n
    assert torch.equal(a.memory.prototype, b.memory.prototype)


def _events():
    """A synthetic trace of one step: a root span [0, 100] holding a
    phase [10, 40]; kernels k1 (launched at 12, in the phase), k2 (at
    50, in the root alone) and k3 (at 150, outside every span), with
    idle gaps before k2 and k3."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "spml.train.step",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "spml.train.forward",
           "ts": 10, "dur": 30},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 11,
           "dur": 5}]
    for corr, (launch, start, dur) in enumerate(
            [(12, 20, 10), (50, 60, 5), (150, 200, 8)], 1):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                   "ts": start, "dur": dur, "args": {"correlation": corr}})
    return ev


def test_by_span_charges_launches_and_gaps():
    rows = profile_step.by_span(_events(), steps=1)
    out = profile_step.OUTSIDE
    assert set(rows) == {"spml.train.step", "spml.train.forward", out}
    fwd, root, rest = rows["spml.train.forward"], rows["spml.train.step"], \
        rows[out]
    # nested: k1 is the phase's alone, k2 the root's own
    assert (fwd["ops"], fwd["device_ms"]) == (1, 0.010)
    assert (root["ops"], root["device_ms"]) == (1, 0.005)
    assert (rest["ops"], rest["device_ms"]) == (1, 0.008)
    assert sum(r["device_ms"] for r in rows.values()) == pytest.approx(0.023)
    # the gap 30-60 closed by k2 (the root's), 65-200 by k3 (outside)
    assert fwd["idle_ms"] == 0
    assert root["idle_ms"] == pytest.approx(0.030)
    assert rest["idle_ms"] == pytest.approx(0.135)
    assert (root["calls"], root["host_ms"]) == (1, 0.1)
    assert (fwd["calls"], fwd["host_ms"]) == (1, 0.03)
    assert (rest["calls"], rest["host_ms"]) == (0, 0)
    half = profile_step.by_span(_events(), steps=2)
    assert half["spml.train.step"]["device_ms"] == pytest.approx(0.0025)
