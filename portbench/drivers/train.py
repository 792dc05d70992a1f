"""A training cell: the port's train step driven in a closed loop over a
ring of distinct batches.

Set-up builds one train state (spml_tpu_torch.train.step.init_state with
the benchmark's weights loaded, strict) and the step closure
(make_train_step), and drives the first CHECKED_STEPS steps of the ring
through the very call and feed the window uses; those are the steps the
check compares, and they warm every shape. The window then steps on
through the ring, one step after the last returns (the host may enqueue
up to two ahead), until --seconds have passed on the host clock. A CUDA
event after each step tiles the window: a step's time runs from the
event before it to its own, so a stall counts. With --trace 1, TRACE_STEPS
steps inside the window run under torch.profiler. Once the window has
closed and the peak is read, the state it left is copied and one more
step goes through the same call: the reference takes that step from the
copy (portbench/checks.py, "the window's state").
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import time

import numpy as np
import torch

from portbench import checks, flops, trace as trace_lib
from portbench import traffic as traffic_lib
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

CHECKED_STEPS = 3
TRACE_AFTER = 5  # window steps before the traced ones
TRACE_STEPS = 8  # under the device-only profile
HOST_STEPS = 3  # under the host-and-device profile


def weights(over: dict, seed: int, device):
    """(embedding, classifier) state dicts of the configuration from the
    seed, made on the device."""
    net, c = over["network"], over["dataset"]["num_classes"]
    gen = torch.Generator(device).manual_seed(traffic_lib.torch_seed(seed, 3))
    emb = ref_model.make_weights(ref_model.embedding_spec(
        net["backbone_types"], net["embedding_dim"]), gen, device)
    cls = ref_model.make_weights(ref_model.classifier_spec(
        c, net["embedding_dim"]), gen, device)
    return emb, cls


def initial(over: dict, seed: int, device) -> dict:
    """The initial leaves {embedding.<name> | prediction.<name>: tensor},
    made on `device`, on the CPU."""
    emb_w, cls_w = weights(over, seed, device)
    return {**{f"embedding.{k}": v.cpu() for k, v in emb_w.items()},
            **{f"prediction.{k}": v.cpu() for k, v in cls_w.items()}}


def reference_run(over: dict, seed: int, ring, device, **lower) -> dict:
    """The plain reference through the CHECKED_STEPS steps from the
    seed's weights and dropout seed ({losses, grad, theta} on the CPU);
    lower: the control's precision (reference/train.py::Reference)."""
    emb_w, cls_w = weights(over, seed, device)
    reference = ref_train.Reference(over, emb_w, cls_w,
                                    traffic_lib.torch_seed(seed, 2), device,
                                    **lower)
    return checks.follow(reference, ring, CHECKED_STEPS)


def _leaves(state) -> dict:
    return {**{f"embedding.{n}": p for n, p
               in state.emb_model.named_parameters()},
            **{f"prediction.{n}": p for n, p
               in state.cls_model.named_parameters()}}


class SegsortWork:
    """While installed, records each fused SegSort loss call that
    spml_tpu_torch.train.step makes (wrapping the names it calls): its
    work (pixels, carrying rows, valid prototypes, width) and, with
    keep, its per-pixel log likelihoods beside their pixel masks. The
    masks are taken by the loss's parameter names; a call whose
    arguments do not bind to them is passed through and makes the work
    unreadable (bound_ms None), never a bound from the wrong tensors."""

    # name -> (family, the pixel masks of its outputs, prototype mask)
    LOSSES = {"fused_joint_losses": ("joint", ("ann_pixel_mask",
                                               "occ_pixel_mask"),
                                     "prototype_mask"),
              "fused_segsort_loss": ("hard", ("pixel_mask",),
                                     "prototype_mask")}

    def __init__(self, step_lib, keep: bool = False):
        self.step_lib, self.calls, self.saved = step_lib, [], {}
        self.keep, self.outputs = keep, []
        self.marks, self.unbound = [], []

    def _wrap(self, name):
        family, pixel_masks, proto_mask = self.LOSSES[name]
        orig = getattr(self.step_lib, name)
        sig = inspect.signature(orig)

        def wrapped(*args, **kwargs):
            try:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                a = bound.arguments
                emb, pmask = a["embeddings"], a[proto_mask]
                masks = [a[m] for m in pixel_masks]
            except (TypeError, KeyError) as e:
                self.unbound.append(f"{name}: {e}")
                return orig(*args, **kwargs)
            rows = masks[0]
            for m in masks[1:]:
                rows = rows | m
            self.calls.append((family, emb.shape[0], emb.shape[1],
                               rows.sum(), pmask.sum(),
                               a.get("operand_dtype") == "bfloat16"))
            out = orig(*args, **kwargs)
            if self.keep:  # (ann, occ) of the joint family, ann alone else
                lls = out if isinstance(out, tuple) else (out,)
                self.outputs += [(ll.detach().cpu(), m.cpu())
                                 for ll, m in zip(lls, masks)]
            return out
        self.saved[name] = orig
        setattr(self.step_lib, name, wrapped)

    def __enter__(self):
        for name in self.LOSSES:
            self._wrap(name)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.step_lib, name, fn)
        self.saved = {}

    def mark(self):
        """A step's end: the calls so far."""
        self.marks.append(len(self.calls))

    def bound_ms(self) -> float | None:
        """The least time of the recorded calls' work, ms; None where no
        step made a call it could read. Raises where the steps made
        different numbers of calls."""
        per_step = [b - a for a, b in zip([0] + self.marks, self.marks)]
        if self.unbound or not self.calls:
            return None
        if len(set(per_step)) != 1:
            raise RuntimeError(f"SegSort loss calls a traced step differ: "
                               f"{per_step}")
        return sum(flops.segsort_bound_ms(f, n, int(nv), d, int(rows), bf)
                   for f, n, d, rows, nv, bf in self.calls)


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _terms(m: dict) -> dict:
    """A step's loss terms as floats, and their sum under "loss"."""
    out = {k: float(v) for k, v in m.items() if k.endswith("_loss")}
    out["loss"] = sum(out.values())
    return out


def _newest(bank: dict) -> dict:
    """The slot a step pushed last: {prototype, semantic, valid}."""
    return {k: bank[k][-1].detach().cpu()
            for k in ("prototype", "semantic", "valid")}


def window_copy(state) -> dict:
    """What the reference needs to go on from `state` (on the CPU): the
    models' state dicts, momentum, bank (the reference's names), step
    count and dropout stream."""
    mem = state.memory
    return {"emb": _cpu(state.emb_model.state_dict()),
            "cls": _cpu(state.cls_model.state_dict()),
            "buf": _cpu(state.momentum),
            "bank": _cpu({"prototype": mem.prototype,
                          "semantic": mem.semantic_label,
                          "valid": mem.valid, "tag": mem.tag,
                          "batch": mem.batch_index}),
            "step": state.step, "generator": state.generator.get_state(),
            "theta": _cpu(_leaves(state))}


def reference_window(over: dict, copy: dict, batch, device,
                     **lower) -> dict:
    """The plain reference's step from `copy` (window_copy) on `batch`:
    {losses, grad, buf0, buf1, theta0, theta1, bank} on the CPU; lower:
    the control's precision."""
    dev = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    reference = ref_train.Reference(over, dev(copy["emb"]), dev(copy["cls"]),
                                    0, device, **lower).resume(
        copy["buf"], copy["bank"], copy["step"], copy["generator"])
    buf0, theta0 = _cpu(reference.buf), _cpu(reference.weights())
    losses, grad = reference.step(batch)
    bank = _newest(reference.bank) \
        if over["train"]["memory_bank_size"] > 0 else None
    return {"losses": losses, "grad": _cpu(grad), "buf0": buf0,
            "buf1": _cpu(reference.buf), "theta0": theta0,
            "theta1": _cpu(reference.weights()), "bank": bank}


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t0: float, keep: bool = False) -> dict:
    """One run of a training cell; cell: {config, traffic, limits};
    keep: also return what the controls need (portbench/control.py)."""
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.train import step as step_lib

    over, traffic = cell["config"]["overrides"], cell["traffic"]
    pcfg = load_config(overrides=over)
    b, crop = pcfg.train.batch_size, pcfg.train.crop_size[0]
    c = pcfg.dataset.num_classes
    ring = traffic_lib.train_ring(traffic, seed, b, crop, c, device)
    dropout_seed = traffic_lib.torch_seed(seed, 2)
    state = step_lib.init_state(pcfg, dropout_seed, ring[0]["image"],
                                device=device)
    emb_w, cls_w = weights(over, seed, device)
    state.emb_model.load_state_dict(emb_w, strict=True)
    state.cls_model.load_state_dict(cls_w, strict=True)
    del emb_w, cls_w
    train_step = step_lib.make_train_step(pcfg)

    # the checked steps: the window's call and feed, the ring's first
    checked, buf1 = [], None
    first = SegsortWork(step_lib, keep=True)  # step 1's SegSort outputs
    for i in range(CHECKED_STEPS):
        with first if i == 0 else contextlib.nullcontext():
            state, m = train_step(state, ring[i])
        checked.append(_terms(m))
        if i == 0:
            buf1 = _cpu(state.momentum)
            segments = float(m["num_segments"])
    theta = _cpu(_leaves(state))

    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    timing = device.type == "cuda"
    events, losses, traced = [], [], None
    quiet = _Quiet() if timing else contextlib.nullcontext()
    with quiet:
        if timing:
            events.append(torch.cuda.Event(enable_timing=True))
            events[0].record()
        start = time.perf_counter()
        i = 0
        while True:
            if trace and i == TRACE_AFTER and traced is None:
                traced = _traced_steps(step_lib, train_step, state, ring, i,
                                       events, losses, sync)
                state = traced.pop("state")
                i += TRACE_STEPS + HOST_STEPS
            state, m = train_step(state, ring[(CHECKED_STEPS + i)
                                              % len(ring)])
            losses.append(m["loss"])
            if timing:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
                if len(events) > 3:
                    events[-3].synchronize()
            i += 1
            if time.perf_counter() - start >= seconds and (
                    not trace or traced is not None):
                break
        sync()
        window_s = time.perf_counter() - start
    steps = i
    peak = torch.cuda.max_memory_allocated() if timing else 0
    failed = sum(not np.isfinite(float(v)) for v in losses)
    step_ms = [a.elapsed_time(e) for a, e in zip(events, events[1:])] \
        if timing else []

    # the step after the window, through its call, from a copy of the
    # state it left
    batch_w = ring[(CHECKED_STEPS + steps) % len(ring)]
    copy = window_copy(state)
    state, m = train_step(state, batch_w)
    prog_w = {"losses": _terms(m), "buf0": copy["buf"],
              "buf1": _cpu(state.momentum), "theta0": copy["theta"],
              "theta1": _cpu(_leaves(state)),
              "bank": _newest({"prototype": state.memory.prototype,
                               "semantic": state.memory.semantic_label,
                               "valid": state.memory.valid})}

    # the check: the program's state freed first
    prog = {"losses": checked, "theta": theta, "segsort": first.outputs}
    del state, train_step, m
    gc.collect()
    if timing:
        torch.cuda.empty_cache()
    p0 = initial(over, seed, device)
    prog["grad"] = checks.gradient_from_momentum(buf1, p0, over["train"])
    ref = reference_run(over, seed, ring, device)
    numbers, info = checks.train_numbers(prog, ref, p0)
    ref_w = reference_window(over, copy, batch_w, device)
    momentum = over["train"]["momentum"]
    numbers.update(checks.window_numbers(prog_w, ref_w, momentum))
    info["window_step"] = copy["step"]
    info["step1_valid_segments"] = segments  # of b x capacity slots
    info["labelled_pixels_pct"] = 100.0 * float(sum(
        (r["semantic_label"] != 255).sum() for r in ring)) / sum(
        r["semantic_label"].numel() for r in ring)

    out = {"attempted": steps, "failed": failed, "peak_bytes": peak,
           "numbers": numbers, "setup_s": setup_s, "window_s": window_s,
           "step_ms": step_ms, "info": info}
    if keep:
        out["kept"] = {"ring": ring, "p0": p0, "ref": ref, "copy": copy,
                       "batch_w": batch_w, "ref_w": ref_w}
    if timing and steps:
        out["metrics"] = {
            "train_images_per_s": steps * b / window_s,
            "train_step_ms_p95": float(np.percentile(step_ms, 95)),
        }
    if traced is not None:
        flops_step = flops.train_step_flops(
            over["network"]["backbone_types"],
            over["network"]["embedding_dim"], b, crop, c)
        traced.update(flops_per_item=flops_step,
                      untraced_items=steps - TRACE_STEPS - HOST_STEPS,
                      untraced_s=window_s - traced["host_s"])
        out["trace"] = traced
    return out


class _Quiet:
    """Around the window: the objects set-up made moved out of the
    garbage collector's reach and the collector off, so that no
    collection stalls a host-bound step (on DensePose's step a full
    collection took 60-100 ms: PERF.md)."""

    def __enter__(self):
        gc.collect()
        gc.freeze()
        gc.disable()
        return self

    def __exit__(self, *exc):
        gc.enable()
        gc.unfreeze()


def _traced_steps(step_lib, train_step, state, ring, i, events, losses,
                  sync):
    """TRACE_STEPS window steps under the device-only profile (the
    SegSort calls' work recorded), then HOST_STEPS under the host one
    (portbench/trace.py::profile), each with its event as in the
    window."""
    held = {"state": state, "i": i}

    def one():
        held["state"], m = train_step(
            held["state"], ring[(CHECKED_STEPS + held["i"]) % len(ring)])
        held["i"] += 1
        losses.append(m["loss"])
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        if work.saved:
            work.mark()

    with SegsortWork(step_lib) as work:  # the device-only profile's steps
        out = trace_lib.profile(one, sync, TRACE_STEPS, HOST_STEPS,
                                lambda on: on and work.__exit__())
    out.update(state=held["state"], segsort_bound_ms=work.bound_ms())
    return out
