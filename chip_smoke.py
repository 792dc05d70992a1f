#!/usr/bin/env python3
"""The port on one CUDA card, end to end: build the kernels, hold each
against its plain version, drive the two ported SPML train steps, report.

Run from the repository root (needs one CUDA card, nvcc and no network):

    python3 chip_smoke.py

Phases, each printing one line or more:
 1. device: the card's name and power limit, torch and CUDA versions;
 2. build: nvcc for sm_90a of every csrc/*.cu, one process each, in
    parallel, with the seconds it took and ptxas's register report;
 3. kernels: each SegSort kernel family through its autograd.Function
    against the plain version, computed in float64 on the same float32
    values (plain version over row chunks):
    - joint, K1 (stats), K2 (dE), K3 (dP): at N = 16384 / P = 2048, D = 64
      (full and ~20% fill, N not a multiple of the tile, all prototypes
      invalid, both kappa branches) and D = 32 (~20% fill), and at the
      flagship N = 131072 / P = 6144, D = 64;
    - hard labels, K4 (stats), K5 (dE), K6 (dP): at N = 16384 / P = 2048,
      D = 32 (full and ~20% fill, ragged N, all invalid) and D = 64, and at
      the DensePose N = 65536 / P = 2048, D = 32, ~15% fill;
 4. main paths, each from random weights of seed 0, 3 warm-up and 10
    timed steps, every loss finite, segments formed, each of its kernels
    launched once per step and the other family's not at all; then each
    kernel timed at the path's own inputs beside the plain version and its
    bound:
    - flagship (panoptic_deeplab_101, crop 512, batch 8, 6x6 k-means x10,
      capacity 256, memory bank 2, sem_ann + sem_occ + img_sim with the
      fused joint loss, bf16 convolutions) on blobby synthetic labels:
      K1-K3;
    - DensePose point (panoptic_pspnet_101_densepose, dim 32, crop 512,
      batch 4, 12x12 k-means x10, capacity 512, no memory bank, sem_ann
      + img_sim with the fused hard-label loss, bf16 convolutions) on
      synthetic point labels, with labelled pixels in the loss: K4-K6;
 5. the kernel list as one JSON line;
 6. the card's name and power limit (nvidia-smi), then the last line
    {"ok": true, "device": {...}}.

Any failed phase raises: the script exits non-zero and prints no result.
Tolerances: the statistics rtol 1e-5 (float32 sums in another order,
amplified by exp(kappa * logit)); dE and dP rtol 1e-4 with atol
1e-5 * max|reference|.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"  # every tensor of the run lives here
STATS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PALLAS = "spml_tpu/ops/pallas/segsort_loss.py"
KERNELS = {  # launch counter -> (name, line of the TPU kernel replaced)
    "joint_stats": ("segsort_joint_stats", f"{PALLAS}:664"),
    "joint_grad_emb": ("segsort_joint_grad_emb", f"{PALLAS}:716"),
    "joint_grad_proto": ("segsort_joint_grad_proto", f"{PALLAS}:716"),
    "hard_stats": ("segsort_hard_stats", f"{PALLAS}:130"),
    "hard_grad_emb": ("segsort_hard_grad_emb", f"{PALLAS}:200"),
    "hard_grad_proto": ("segsort_hard_grad_proto", f"{PALLAS}:240"),
}
KINDS = ("stats", "grad_emb", "grad_proto")
N_STATS = {"joint": 6, "hard": 3}
N_KAPPAS = {"joint": 2, "hard": 1}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

def make_case(torch, n, p, fill, seed, d=64, n_classes=21, n_tags=20):
    """Inputs of the joint kernels as the wrapper hands them over:
    prototypes sorted valid-first, pixels near their own prototype."""
    rng = np.random.RandomState(seed)
    nv = int(round(fill * p))
    protos = rng.randn(p, d)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    own = rng.randint(0, max(nv, 1), n)
    stray = rng.rand(n) < 0.05  # own prototype past the valid count
    own[stray] = rng.randint(0, p, stray.sum())
    emb = protos[own] + 0.35 * rng.randn(n, d) / math.sqrt(d)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    plab = np.where(np.arange(p) < nv, rng.randint(0, n_classes, p), -1)
    pval = (np.arange(p) < nv).astype(np.int32)
    ptag = rng.randint(0, 2 ** n_tags, p)
    lab = np.where(rng.rand(n) < 0.9, plab[own], rng.randint(0, n_classes,
                                                             n))
    tag = rng.randint(0, 2 ** n_tags, n)

    def cuda(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=DEVICE)

    f32, i32 = torch.float32, torch.int32
    return dict(emb=cuda(emb, f32), pix_lab=cuda(lab, i32),
                own_idx=cuda(own, i32), pix_tags=cuda(tag, i32),
                protos=cuda(protos, f32), proto_lab=cuda(plab, i32),
                proto_tags=cuda(ptag, i32), proto_valid=cuda(pval, i32),
                num_valid=cuda([nv], i32))


def stats_args(family, case, emb, protos, rows=slice(None)):
    """The positional tensor arguments of the family's stats function
    (pixel arrays cut to `rows`)."""
    c = case
    if family == "joint":
        return [emb, c["pix_lab"][rows], c["own_idx"][rows],
                c["pix_tags"][rows], protos, c["proto_lab"],
                c["proto_tags"], c["proto_valid"], c["num_valid"]]
    return [emb, c["pix_lab"][rows], c["own_idx"][rows], protos,
            c["proto_lab"], c["num_valid"]]


def stats_fns(fused, family):
    """(kernel path, plain version) of a family."""
    if family == "joint":
        return fused.joint_segsort_stats, fused.joint_segsort_stats_reference
    return fused.segsort_stats, fused.segsort_stats_reference


def reference64(torch, fused, family, case, grads, kappas, rows=16384):
    """Plain version in float64 over row chunks: stats, dE, dP."""
    stats, d_emb = [], []
    d_protos = torch.zeros_like(case["protos"], dtype=torch.float64)
    n = case["emb"].shape[0]
    plain = stats_fns(fused, family)[1]
    for r0 in range(0, n, rows):
        sl = slice(r0, min(r0 + rows, n))
        e = case["emb"][sl].double().requires_grad_(True)
        p = case["protos"].double().requires_grad_(True)
        s = plain(*stats_args(family, case, e, p, sl), *kappas)
        ge, gp = torch.autograd.grad((s * grads[:, sl].double()).sum(),
                                     (e, p))
        stats.append(s.detach())
        d_emb.append(ge)
        d_protos += gp
    return torch.cat(stats, 1), torch.cat(d_emb), d_protos


def kernel_outputs(torch, fused, family, case, grads, kappas):
    e = case["emb"].clone().requires_grad_(True)
    p = case["protos"].clone().requires_grad_(True)
    s = stats_fns(fused, family)[0](*stats_args(family, case, e, p),
                                    *kappas)
    s.backward(grads)
    torch.cuda.synchronize()
    return s.detach(), e.grad, p.grad


def check_case(torch, fused, family, label, case, kappas, seed):
    n = case["emb"].shape[0]
    g = torch.randn(N_STATS[family], n, device=DEVICE,
                    generator=torch.Generator(DEVICE).manual_seed(seed))
    s, de, dp = kernel_outputs(torch, fused, family, case, g, kappas)
    rs, rde, rdp = reference64(torch, fused, family, case, g, kappas)
    errs, margins = {}, {}
    for name, got, ref, rtol, atol in (
            ("stats", s, rs, STATS_RTOL, 0.0),
            ("dE", de, rde, GRAD_RTOL, GRAD_ATOL_REL),
            ("dP", dp, rdp, GRAD_RTOL, GRAD_ATOL_REL)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: {name} not finite")
        ref = ref.float()
        abs_tol = atol * float(ref.abs().max())
        torch.testing.assert_close(got, ref, rtol=rtol, atol=abs_tol,
                                   msg=lambda m: f"{label} {name}: {m}")
        err = (got - ref).abs()
        errs[name] = float(err.max())
        # share of the tolerance used by the worst element (<= 1 passes)
        margins[name] = float((err / (abs_tol + rtol * ref.abs())
                               .clamp(min=1e-38)).max())
    log("kernels", f"{family} {label}: N={n} P={case['protos'].shape[0]} "
        f"D={case['emb'].shape[1]} valid={int(case['num_valid'])} "
        f"kappa={kappas} max_abs_err "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + " | tolerance used "
        + " ".join(f"{k}={v:.3f}" for k, v in margins.items()) + " ok")
    return errs


def check_kernels(torch, fused):
    """Both families' cases; returns {family: errors of its main-path
    sized case (the last)}."""
    mid = 16384
    cases = {
        "joint": [
            ("mid full fill", (mid, 2048, 1.0, 1, 64), (6.0, 12.0)),
            ("mid 20% fill", (mid, 2048, 0.2, 2, 64), (6.0, 12.0)),
            ("mid ragged N, two exps", (mid - 1, 2048, 0.2, 3, 64),
             (6.0, 10.0)),
            ("mid all invalid", (mid, 2048, 0.0, 4, 64), (6.0, 12.0)),
            ("mid 20% fill", (mid, 2048, 0.2, 6, 32), (6.0, 12.0)),
            ("flagship 17% fill", (131072, 6144, 0.17, 5, 64),
             (6.0, 12.0))],
        "hard": [
            ("mid full fill", (mid, 2048, 1.0, 11, 32), (6.0,)),
            ("mid 20% fill", (mid, 2048, 0.2, 12, 32), (6.0,)),
            ("mid ragged N", (mid - 1, 2048, 0.2, 13, 32), (6.0,)),
            ("mid all invalid", (mid, 2048, 0.0, 14, 32), (6.0,)),
            ("mid 20% fill", (mid, 2048, 0.2, 15, 64), (6.0,)),
            ("DensePose 15% fill", (65536, 2048, 0.15, 16, 32), (6.0,))],
    }
    errs = {}
    for family, family_cases in cases.items():
        for label, (n, p, fill, seed, d), kappas in family_cases:
            case = make_case(torch, n, p, fill, seed, d=d)
            errs[family] = check_case(torch, fused, family, label, case,
                                      kappas, seed=seed)
    return errs


# ---------------------------------------------------------------------------
# Main paths
# ---------------------------------------------------------------------------

def path_setup(recipe):
    """(config, batch, family of its loss kernels) of a main path."""
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.train import densepose_point, flagship

    if recipe == "flagship":
        cfg = load_config(overrides=flagship.OVERRIDES)
        b, crop = cfg.train.batch_size, cfg.train.crop_size[0]
        batch = flagship.blobby_batch(b, crop, cfg.dataset.num_classes,
                                      device=DEVICE)
        return cfg, batch, "joint"
    cfg = load_config(overrides=densepose_point.OVERRIDES)
    b, crop = cfg.train.batch_size, cfg.train.crop_size[0]
    return cfg, densepose_point.point_batch(b, crop, seed=0,
                                            device=DEVICE), "hard"


def run_main_path(torch, fused, recipe):
    """3 warm-up and 10 timed steps of one recipe; returns (launch counts,
    the last call's stats inputs)."""
    from spml_tpu_torch.train import step as step_lib

    cfg, batch, family = path_setup(recipe)
    b = cfg.train.batch_size
    t0 = time.perf_counter()
    state = step_lib.init_state(cfg, 0, batch["image"], device=DEVICE)
    train_step = step_lib.make_train_step(cfg)
    log(recipe, f"state built in {time.perf_counter() - t0:.1f} s")

    last, masked = {}, []
    stats_name = "joint_segsort_stats" if family == "joint" else \
        "segsort_stats"
    orig_stats, orig_ll = getattr(fused, stats_name), fused._ll_from_stats

    def recording(*args):  # keeps the last call's inputs for the timings
        last["args"] = [a.detach() if torch.is_tensor(a) else a
                        for a in args]
        return orig_stats(*args)

    def counting(own_s, same_s, diff_s, pixel_mask, reduction="mean"):
        masked.append(pixel_mask.sum())  # pixels in the loss, read later
        return orig_ll(own_s, same_s, diff_s, pixel_mask, reduction)

    setattr(fused, stats_name, recording)
    fused._ll_from_stats = counting
    metrics_log = []
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    try:
        for _ in range(3):
            state, m = train_step(state, batch)
            metrics_log.append(m)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(10):
            state, m = train_step(state, batch)
            metrics_log.append(m)
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    finally:
        setattr(fused, stats_name, orig_stats)
        fused._ll_from_stats = orig_ll
    launches = dict(fused.LAUNCHES)

    steps = len(metrics_log)
    losses = {k: [float(m[k]) for m in metrics_log]
              for k in metrics_log[0] if k.endswith("loss")}
    nsegs = [int(m["num_segments"]) for m in metrics_log]
    if not all(math.isfinite(x) for v in losses.values() for x in v):
        raise AssertionError(f"{recipe}: non-finite loss: {losses}")
    if min(nsegs) <= 0:
        raise AssertionError(f"{recipe}: no segments formed: {nsegs}")
    if min(int(x) for x in masked) <= 0:
        raise AssertionError(f"{recipe}: a step had no pixel in the loss")
    for key in KERNELS:
        want = steps if key.startswith(family) else 0
        if launches[key] != want:
            raise AssertionError(f"{recipe}: {key} launched {launches[key]}"
                                 f" times in {steps} steps, want {want}")
    ms = start.elapsed_time(end) / 10
    cap = b * cfg.tpu.segment_capacity
    loss = losses["loss"]
    log(recipe, f"{steps} steps, loss {loss[0]:.4f} -> {loss[-1]:.4f} ("
        + ", ".join(f"{k} {v[-1]:.4f}" for k, v in losses.items()
                    if k != "loss")
        + f"), segments {nsegs[-1]}/{cap} ({nsegs[-1] / cap:.1%} of "
        f"capacity), loss pixels {int(masked[-1])}, kernel valid count "
        f"{int(last['args'][-1 - N_KAPPAS[family]])}, accuracy step 0 "
        f"{float(metrics_log[0]['accuracy']):.4f}")
    log(recipe, f"train step {ms:.2f} ms (CUDA events; host clock "
        f"{host_s * 100:.2f} ms), {b * 1000 / ms:.2f} imgs/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}, card {nvidia_smi_line()}")
    return launches, last["args"]


# ---------------------------------------------------------------------------
# Timings at the main paths' inputs
# ---------------------------------------------------------------------------

def cuda_time(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bounds(family, n, p, nv, d):
    """{kind: (bound_ms, bound_by)} of a family from this run's shapes:
    bytes each input read once and each output written once (prototype
    rows up to the valid count), operations per live (pixel, prototype)
    pair."""
    pairs = n * nv
    ns = N_STATS[family]
    if family == "joint":  # rows carry label, own / tag, valid
        pix_in, protos_in = n * (d * 4 + 3 * 4), nv * (d * 4 + 3 * 4)
        ops_stats, ops_grad = 2 * d + 10, 4 * d + 14  # 2 exps, 6 sums
    else:  # rows carry label, own / label
        pix_in, protos_in = n * (d * 4 + 8), nv * (d * 4 + 4)
        ops_stats, ops_grad = 2 * d + 6, 4 * d + 8
    work = {  # bytes, operations
        "stats": (pix_in + protos_in + ns * n * 4, pairs * ops_stats),
        "grad_emb": (pix_in + ns * n * 4 + protos_in + n * d * 4,
                     pairs * ops_grad),
        "grad_proto": (pix_in + ns * n * 4 + protos_in + p * d * 4,
                       pairs * ops_grad),
    }
    out = {}
    for kind, (nbytes, ops) in work.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        out[kind] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def time_kernels(torch, fused, family, args):
    """Each kernel of a family at a main path's last inputs (CUDA events,
    20 launches) beside the plain version (3 runs over row chunks) and
    its bound; returns {counter: (ms, plain ms, (bound ms, by))}."""
    ns, nk = N_STATS[family], N_KAPPAS[family]
    tensors, kappas = args[:-nk], tuple(args[-nk:])
    scalars = kappas  # as the C functions take them
    if family == "joint":
        scalars = (*kappas, int(kappas[1] == 2.0 * kappas[0]))
    f32, i32 = torch.float32, torch.int32
    at = 4 if family == "joint" else 3  # the prototypes among the inputs
    inputs = tuple(fused._kernel_operand(t, f32 if i in (0, at) else i32)
                   for i, t in enumerate(tensors))
    emb, protos = inputs[0], inputs[at]
    n, d = emb.shape
    p = protos.shape[0]
    nv = int(inputs[-1])
    grads = torch.randn(ns, n, device=DEVICE)
    kernel_ms = {
        "stats": cuda_time(
            torch, lambda: fused._launch_stats(family, inputs, scalars), 20),
        "grad_emb": cuda_time(
            torch, lambda: fused._launch_grad_emb(family, inputs, scalars,
                                                  grads), 20),
        "grad_proto": cuda_time(
            torch, lambda: fused._launch_grad_proto(family, inputs, scalars,
                                                    grads), 20),
    }

    rows = 32768  # the plain version over row chunks (it is [N, P] dense)
    plain_fn = stats_fns(fused, family)[1]

    def plain(kind):
        for r0 in range(0, n, rows):
            sl = slice(r0, min(r0 + rows, n))
            e = emb[sl].detach().requires_grad_(kind == "grad_emb")
            pr = protos.detach().requires_grad_(kind == "grad_proto")
            pix = [t[sl] for t in inputs[1:at]]
            s = plain_fn(e, *pix, pr, *inputs[at + 1:], *kappas)
            if kind != "stats":
                torch.autograd.grad((s * grads[:, sl]).sum(),
                                    e if kind == "grad_emb" else pr)

    plain_ms = {kind: cuda_time(torch, lambda: plain(kind), 3)
                for kind in KINDS}
    bnd = bounds(family, n, p, nv, d)
    out = {}
    for kind in KINDS:
        key = f"{family}_{kind}"
        out[key] = (kernel_ms[kind], plain_ms[kind], bnd[kind])
        log("timing", f"{KERNELS[key][0]}: N={n} P={p} valid={nv} D={d} "
            f"kernel {kernel_ms[kind]:.4f} ms, plain {plain_ms[kind]:.3f} "
            f"ms, bound {bnd[kind][0]:.4f} ms ({bnd[kind][1]})")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from spml_tpu_torch.ops import _cuda, segsort_loss as fused

    smi = nvidia_smi_line()
    log("device", f"{smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = _cuda.build()
    regs = [ln.strip() for r in reports.values() for ln in r.splitlines()
            if "registers" in ln or "spill" in ln]
    log("build", f"{len(reports)} source(s) in "
        f"{time.perf_counter() - t0:.1f} s; ptxas: " + " | ".join(regs))

    errs = check_kernels(torch, fused)
    launches, times = {}, {}
    for recipe, family in (("flagship", "joint"), ("densepose", "hard")):
        path_launches, args = run_main_path(torch, fused, recipe)
        launches.update({k: v for k, v in path_launches.items()
                         if k.startswith(family)})
        times.update(time_kernels(torch, fused, family, args))

    err_name = {"stats": "stats", "grad_emb": "dE", "grad_proto": "dP"}
    table = []
    for key, (name, replaces) in KERNELS.items():
        family, kind = key.split("_", 1)
        ms, plain_ms, (bound_ms, bound_by) = times[key]
        table.append({
            "name": name, "route": "cuda",
            "source": "spml_tpu_torch/csrc/segsort_joint.cu",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errs[family][err_name[kind]], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": table}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
