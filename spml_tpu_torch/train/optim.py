"""SGD with momentum, per-parameter-group LR multipliers and weight-decay
masks, plus the reference LR schedules.

Port of the SGD half of spml_tpu/train/optim.py (reference in
twke18/SPML: lib/nn/optimizer.py:18-104 and spml/utils/general/train.py
:8-57). The update order is the reference's, written out by hand because
torch.optim.SGD applies the learning rate after the momentum buffer:

    d = g + wd * p          (wd only on weight-like groups)
    d = d * group_mult * lr(step)
    buf = momentum * buf + d
    p -= buf

Folding the LR into the buffer means old gradients decay at the LR of
their own step. Groups: backbone res3-5 weights x1 / biases x2, heads
(ASPP or PSPP, classifier) weights x10 / biases x20, biases without weight decay;
the stem and res2 are in no group: frozen. Adam is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

FROZEN = "frozen"
BACKBONE_W = "backbone_w"
BACKBONE_B = "backbone_b"
HEAD_W = "head_w"
HEAD_B = "head_b"

GROUP_MULT = {FROZEN: 0.0, BACKBONE_W: 1.0, BACKBONE_B: 2.0,
              HEAD_W: 10.0, HEAD_B: 20.0}
GROUP_WD = {FROZEN: False, BACKBONE_W: True, BACKBONE_B: False,
            HEAD_W: True, HEAD_B: False}


def lr_poly(base_lr: float, max_iter: int, warmup_iter: int = 0,
            power: float = 0.9) -> Callable[[int], float]:
    def schedule(step):
        left = 1.0 - step / max_iter
        # past max_iter the JAX schedule's float32 power is nan, where a
        # Python power of a negative base would be complex
        poly = base_lr * left ** power if left >= 0 else math.nan
        if warmup_iter > 0 and step < warmup_iter:
            alpha = step / warmup_iter
            return min(base_lr * (0.1 * (1.0 - alpha) + alpha), poly)
        return poly
    return schedule


def lr_step(base_lr: float, decay_iters: tuple[int, ...],
            warmup_iter: int = 0) -> Callable[[int], float]:
    def schedule(step):
        if warmup_iter > 0 and step < warmup_iter:
            alpha = step / warmup_iter
            return base_lr * (0.1 * (1.0 - alpha) + alpha)
        return base_lr * 0.1 ** sum(step >= d for d in decay_iters)
    return schedule


def make_schedule(train_cfg) -> Callable[[int], float]:
    if train_cfg.lr_policy == "step":
        return lr_step(train_cfg.base_lr, tuple(train_cfg.decay_iterations),
                       train_cfg.warmup_iteration)
    return lr_poly(train_cfg.base_lr, train_cfg.max_iteration,
                   train_cfg.warmup_iteration)


def label_param(name: str) -> str:
    """Optimizer group of a parameter, by its state-dict name (an
    'embedding.'/'prediction.' prefix may come first)."""
    parts = name.split(".")
    is_bias = parts[-1] == "bias"
    if "resnet_backbone" in parts:
        stage = parts[parts.index("resnet_backbone") + 1]
        if stage in ("conv1", "res2"):  # stem + res2
            return FROZEN
        return BACKBONE_B if is_bias else BACKBONE_W
    return HEAD_B if is_bias else HEAD_W


@torch.no_grad()
def sgd_step(named_params, momentum_buffers: dict, lr: float,
             weight_decay: float, momentum: float) -> None:
    """One in-place SGD update in the reference's order (module
    docstring). named_params: (name, parameter) pairs; frozen groups and
    parameters without a gradient are skipped. momentum_buffers: name ->
    buffer, created as zeros on first use."""
    groups: dict[str, tuple[list, list, list]] = {}
    for name, p in named_params:
        label = label_param(name)
        if label == FROZEN or p.grad is None:
            continue
        if name not in momentum_buffers:
            momentum_buffers[name] = torch.zeros_like(p)
        ps, gs, bufs = groups.setdefault(label, ([], [], []))
        ps.append(p)
        gs.append(p.grad)
        bufs.append(momentum_buffers[name])
    for label, (ps, gs, bufs) in groups.items():
        if GROUP_WD[label]:
            d = torch._foreach_add(gs, ps, alpha=weight_decay)
        else:
            d = [g.clone() for g in gs]
        torch._foreach_mul_(d, GROUP_MULT[label])
        torch._foreach_mul_(d, lr)
        torch._foreach_mul_(bufs, momentum)
        torch._foreach_add_(bufs, d)
        torch._foreach_sub_(ps, bufs)
