"""Profiling a few steps inside the window, and reading the traces into
what the per-layer metrics need.

CATEGORIES, category() and busy_us() are frozen copies of
spml_tpu_torch/tools/profile_step.py:44-74 (the kernel categories by name
pattern, first match wins, and the union of device intervals).
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time

import torch

CATEGORIES = [  # first match wins; cuDNN's conv kernels also say "gemm"
    ("segsort loss K1-K9", r"(grad_tile|stats_tile)_kernel<|reduce_tiles"),
    ("conv (cuDNN)", r"fprop|dgrad|wgrad|implicit|conv|cudnn|"
                     r"nchwToNhwc|nhwcToNchw"),
    ("matmul (cuBLAS)", r"gemm|gemv|Gemm|nvjet|splitK"),
    ("batch norm", r"batch_norm|bn_|welford|Welford"),
    ("resize / pool / softmax", r"upsample|pool|softmax"),
    ("sort / scan", r"[Ss]ort|scan|Scan|cub::"),
    ("optimizer (foreach)", r"multi_tensor_apply"),
    ("reduction", r"reduce_kernel|Reduce"),
    ("index / scatter / gather", r"index|scatter|gather|Index|Scatter"),
    ("elementwise", r"elementwise|Elementwise|vectorized"),
    ("copy / memset", r"Memcpy|Memset|memcpy|memset|copy"),
]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def busy_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps_between(intervals):
    """[(start, end)] of the gaps between the union's intervals."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


class Trace:
    """The events of one profiled window.

    device: kernels, copies and sets ({name, ts, dur, cat, correlation});
    cpu_ops: the host's operator events; spans: the benchmark's
    record_function ranges ({name: [(start, end)]}); launch_ts:
    correlation id -> the host time of the launch call."""

    def __init__(self, events: list):
        self.device, self.cpu_ops, self.spans = [], [], {}
        self.launch_ts = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                self.device.append(e)
            elif cat == "cpu_op":
                self.cpu_ops.append(e)
            elif cat == "user_annotation":
                self.spans.setdefault(e["name"], []).append(
                    (e["ts"], e["ts"] + e["dur"]))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch_ts[corr] = e["ts"]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """Exported to a file under TMPDIR, read, and the file removed."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return cls(events)

    def intervals(self):
        return [(e["ts"], e["ts"] + e["dur"]) for e in self.device]

    def busy_s(self) -> float:
        return busy_us(self.intervals()) / 1e6

    def ms_by_category(self) -> dict:
        out = {}
        for e in self.device:
            c = category(e["name"])
            out[c] = out.get(c, 0.0) + e["dur"] / 1e3
        return out

    def ms_under_span(self, name: str) -> float | None:
        """Device ms of the work launched inside the spans `name`; None
        when no such span was entered or nothing launched there."""
        spans = sorted(self.spans.get(name, []))
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total, found = 0.0, False
        for e in self.device:
            ts = self.launch_ts.get(e.get("args", {}).get("correlation"))
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                total += e["dur"] / 1e3
                found = True
        return total if found else None

    def device_ops(self, top: int = 10) -> list:
        """[[name, s]] of the device operations that took most time."""
        by_name = {}
        for e in self.device:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], s] for n, s in ops]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host op, s]]: the device's idle gaps summed by the host
        operator that was running at each gap's start (the earliest
        begun of those still open)."""
        outer = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in self.cpu_ops)
        starts = [o[0] for o in outer]
        by_host = {}
        for s, e in gaps_between(self.intervals()):
            i = bisect.bisect_right(starts, s) - 1
            name = "no host operator"
            # the earliest-starting operator still open at s is outermost
            for j in range(max(0, i - 64), i + 1):
                if outer[j][0] <= s <= outer[j][1]:
                    name = outer[j][2]
                    break
            by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e6
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], s] for n, s in gaps]


def profile(step, sync, device_items: int, host_items: int,
            on_host=lambda on: None) -> dict:
    """step() `device_items` times under a device-only profile (the
    device's busy time, idle share and kernel times, with little cost to
    the host), then `host_items` times under a host-and-device profile
    (host operators, the benchmark's spans, what the host did in the
    idle gaps; the host runs slower there). on_host(True / False) marks
    the second. Returns {trace, window_s, items, host_trace, host_items,
    host_s}: window_s the first profile's host time, host_s both's."""
    acts = torch.profiler.ProfilerActivity
    t0 = time.perf_counter()
    sync()
    with torch.profiler.profile(activities=[acts.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(device_items):
            step()
        sync()
        window_s = time.perf_counter() - t
    dev = Trace.from_profiler(prof)
    on_host(True)
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        for _ in range(host_items):
            step()
        sync()
    on_host(False)
    return {"trace": dev, "window_s": window_s, "items": device_items,
            "host_trace": Trace.from_profiler(prof),
            "host_items": host_items, "host_s": time.perf_counter() - t0}
