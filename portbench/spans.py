"""Counts over the program's own spans in a host profile
(portbench/trace.py::Trace), shared by the per-layer metrics that count
device operations (portbench/metrics/)."""

from __future__ import annotations

import bisect


def count_under_span(trace, name: str) -> int | None:
    """Device operations (kernels, copies, sets) of `trace` whose launch
    (the runtime call of the same correlation id) lies inside a span
    `name`; None when no such span was entered."""
    spans = sorted(trace.spans.get(name, []))
    if not spans:
        return None
    starts = [s for s, _ in spans]
    ops = 0
    for e in trace.device:
        ts = trace.launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        ops += i >= 0 and ts <= spans[i][1]
    return ops
