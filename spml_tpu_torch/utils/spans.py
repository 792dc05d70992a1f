"""Named spans of the port's own phases, on the profiler's clock.

span(name) is a torch.profiler.record_function range while a torch
profiler records, so each span lands in the same Chrome trace as the
kernels and the runtime's launch calls, and a device operation or idle
gap can be put down to the span in which its launch was made. With no
profiler running it returns one shared no-op context: no record_function
is built, nothing is allocated and nothing waits on the device. Any
profile records them (train/driver.py::TraceWindow,
tools/profile_step.py, a benchmark's own); the program keeps no span log
of its own.

Spans nest: a train step's or an image's root span holds the spans of
its phases, and is the identifier they share.

    spml.train.step      train/step.py::make_train_step's train_step,
                         tiled by .forward, .kmeans, .losses, .backward
                         and .update
    spml.infer.image     inference/engine.py::predict_semantic, which
                         holds one spml.infer.upload (upload_image)
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: record_function(name) while a torch profiler
    records, else the shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
