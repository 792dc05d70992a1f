"""The per-layer metrics that read the program's own spans
(spml_tpu_torch/utils/spans.py), on synthetic host profiles: each value
from known spans and kernels, and nothing where the program opens no
span, as a program without them (the kernels and the benchmark's own
spans alone)."""

from __future__ import annotations

import pytest

from portbench import run
from portbench.spans import count_under_span
from portbench.trace import Trace

TRAIN = ("forward", "kmeans", "losses", "backward", "update")


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _kernels(launches):
    """A runtime launch and its kernel for each (launch ts, kernel dur),
    the kernel starting 5 us after its launch."""
    out = []
    for corr, (ts, dur) in enumerate(launches, 1):
        out += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                 "ts": ts, "dur": 1, "args": {"correlation": corr}},
                {"ph": "X", "cat": "kernel", "name": f"k{corr}",
                 "ts": ts + 5, "dur": dur, "args": {"correlation": corr}}]
    return out


def _train_steps(spans=True):
    """Two steps of 1000 us; in each, phase p (0-4) spans [200 p, 200 p +
    200) and launches p + 1 kernels of (p + 1) * 100 us; one kernel
    launched between the steps, outside every span."""
    ev, launches = [], []
    for step in range(2):
        t0 = 2000 * step
        if spans:
            ev.append(_span("spml.train.step", t0, 1000))
        for p, name in enumerate(TRAIN):
            if spans:
                ev.append(_span(f"spml.train.{name}", t0 + 200 * p, 200))
            launches += [(t0 + 200 * p + 10 * k + 1, (p + 1) * 100)
                         for k in range(p + 1)]
        launches.append((t0 + 1500, 7000))
    return {"host_trace": Trace(ev + _kernels(launches)), "host_items": 2}


def _images(spans=True):
    """Two images of 1000 us under spml.infer.image, each an upload span
    of 300 us launching 2 kernels and 3 more kernels after it; the
    benchmark's own portbench.stitch span around the last."""
    ev, launches = [], []
    for img in range(2):
        t0 = 2000 * img
        ev.append(_span("portbench.stitch", t0 + 600, 300))
        if spans:
            ev += [_span("spml.infer.image", t0, 1000),
                   _span("spml.infer.upload", t0 + 10, 300)]
        launches += [(t0 + 20, 50), (t0 + 30, 50), (t0 + 400, 10),
                     (t0 + 500, 10), (t0 + 700, 10)]
    return {"host_trace": Trace(ev + _kernels(launches)), "host_items": 2}


@pytest.mark.parametrize("phase", range(5))
def test_train_phase_ms(phase):
    mod = run.load_metric(f"{TRAIN[phase]}_ms.train")
    # (p + 1) kernels of (p + 1) * 100 us a step
    assert mod.read(_train_steps()) == pytest.approx((phase + 1) ** 2 * 0.1)


def test_launches_per_step():
    mod = run.load_metric("launches_per_step.train")
    assert mod.read(_train_steps()) == 15  # the kernel between, not


def test_upload_host_ms():
    assert run.load_metric("upload_host_ms.infer").read(_images()) \
        == pytest.approx(0.3)


def test_launches_per_image():
    assert run.load_metric("launches_per_image.infer").read(_images()) == 5


@pytest.mark.parametrize("name", [f"{p}_ms.train" for p in TRAIN]
                         + ["launches_per_step.train"])
def test_train_metrics_read_nothing_without_spans(name):
    assert run.load_metric(name).read(_train_steps(spans=False)) is None


@pytest.mark.parametrize("name", ["upload_host_ms.infer",
                                  "launches_per_image.infer"])
def test_infer_metrics_read_nothing_without_spans(name):
    assert run.load_metric(name).read(_images(spans=False)) is None


def test_count_under_span():
    trace = _train_steps()["host_trace"]
    assert count_under_span(trace, "spml.train.step") == 30
    assert count_under_span(trace, "spml.train.update") == 10
    assert count_under_span(trace, "spml.train.other") is None
