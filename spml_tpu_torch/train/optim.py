"""SGD with momentum and the reference's Adam, with per-parameter-group
LR multipliers and weight-decay masks, plus the reference LR schedules.

Port of spml_tpu/train/optim.py (reference in twke18/SPML:
lib/nn/optimizer.py:18-197 and spml/utils/general/train.py:8-57). Both
updates are written out by hand as in-place foreach operations, in the
reference's order. SGD (torch.optim.SGD would apply the learning rate
after the momentum buffer):

    d = g + wd * p          (wd only on weight-like groups)
    d = d * group_mult * lr(step)
    buf = momentum * buf + d
    p -= buf

Folding the LR into the buffer means old gradients decay at the LR of
their own step. Adam (lib/nn/optimizer.py:107-179; torch.optim.Adam
puts eps after the bias correction):

    g = g + wd * p          (L2 folded into the gradient, wd groups)
    mu = b1 * mu + (1 - b1) * g;  nu = b2 * nu + (1 - b2) * g * g
    u = sqrt(1 - b2^t) / (1 - b1^t) * mu / (sqrt(nu) + eps)
    p -= u * group_mult * lr(step)

with one count t per state. Groups: backbone res3-5 weights x1 / biases
x2, heads (ASPP or PSPP, classifier) weights x10 / biases x20, biases
without weight decay; the stem and res2 are in no group: frozen, never
updated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
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


def _grouped(named_params, *buffers):
    """label -> ([parameters], [gradients], [buffer lists...]) of the
    parameters that are trained and have a gradient; each `buffers` dict
    (name -> tensor) gets zeros for a name it lacks."""
    groups: dict[str, tuple[list, ...]] = {}
    for name, p in named_params:
        label = label_param(name)
        if label == FROZEN or p.grad is None:
            continue
        for bufs in buffers:
            if name not in bufs:
                bufs[name] = torch.zeros_like(p)
        lists = groups.setdefault(
            label, tuple([] for _ in range(2 + len(buffers))))
        lists[0].append(p)
        lists[1].append(p.grad)
        for i, bufs in enumerate(buffers):
            lists[2 + i].append(bufs[name])
    return groups


@torch.no_grad()
def sgd_step(named_params, momentum_buffers: dict, lr: float,
             weight_decay: float, momentum: float) -> None:
    """One in-place SGD update in the reference's order (module
    docstring). named_params: (name, parameter) pairs; frozen groups and
    parameters without a gradient are skipped. momentum_buffers: name ->
    buffer, created as zeros on first use."""
    for label, (ps, gs, bufs) in _grouped(named_params,
                                          momentum_buffers).items():
        if GROUP_WD[label]:
            d = torch._foreach_add(gs, ps, alpha=weight_decay)
        else:
            d = [g.clone() for g in gs]
        torch._foreach_mul_(d, GROUP_MULT[label])
        torch._foreach_mul_(d, lr)
        torch._foreach_mul_(bufs, momentum)
        torch._foreach_add_(bufs, d)
        torch._foreach_sub_(ps, bufs)


ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@torch.no_grad()
def adam_step(named_params, mu: dict, nu: dict, count: int, lr: float,
              weight_decay: float, betas=ADAM_BETAS,
              eps: float = ADAM_EPS) -> int:
    """One in-place Adam update in the reference's order (module
    docstring); returns the new count. mu, nu: name -> moment, created as
    zeros on first use; frozen groups and parameters without a gradient
    are skipped. The bias correction is computed in float32, as the JAX
    package's."""
    b1, b2 = betas
    count += 1
    t = np.float32(count)
    scale = float(np.sqrt(np.float32(1.0) - np.float32(b2) ** t)
                  / (np.float32(1.0) - np.float32(b1) ** t))
    for label, (ps, gs, ms, vs) in _grouped(named_params, mu, nu).items():
        if GROUP_WD[label]:
            gs = torch._foreach_add(gs, ps, alpha=weight_decay)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1.0 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1.0 - b2)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_mul(ms, scale)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, GROUP_MULT[label])
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(ps, upd)
    return count


def build_optimizer(train_cfg):
    """The update of train.optimizer ('sgd' | 'adam'), the config-level
    counterpart of the reference importing SGD or Adam from
    lib/nn/optimizer.py: update(named_params, state, lr) -> state, with
    the parameters and the state's buffers (momentum; adam_mu, adam_nu)
    changed in place and adam_count advanced."""
    kind = train_cfg.optimizer
    if kind == "sgd":
        def update(named_params, state, lr):
            sgd_step(named_params, state.momentum, lr,
                     train_cfg.weight_decay, train_cfg.momentum)
            return state
        return update
    if kind == "adam":
        def update(named_params, state, lr):
            count = adam_step(named_params, state.adam_mu, state.adam_nu,
                              state.adam_count, lr, train_cfg.weight_decay)
            return dataclasses.replace(state, adam_count=count)
        return update
    raise ValueError(f"train.optimizer must be 'sgd' or 'adam', got {kind!r}")


def clip_grads(grads: list, clip_value: float) -> list:
    """Elementwise clamp to [-clip_value, clip_value] (lib/nn/
    optimizer.py:182-197; the reference's train scripts do not enable
    it)."""
    return torch._foreach_clamp_max(
        torch._foreach_clamp_min(grads, -clip_value), clip_value)
