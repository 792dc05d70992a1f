"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The default is the CUDA card; a
    host without one raises instead of carrying on quietly on the CPU —
    pass device="cpu" to run the plain versions there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def float32_matmuls() -> None:
    """torch.backends.{cuda.matmul,cudnn}.allow_tf32 = False for the
    process, as the train steps set it: inference's k-means E-step, KNN
    ranking, classifier logits and the random walk's 64 powers of a
    transition stay full float32, since near-ties of affinities decide
    labels and TF32's 10-bit mantissa moves them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
