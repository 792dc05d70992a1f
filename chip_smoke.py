#!/usr/bin/env python3
"""The port on one CUDA card, end to end: build the kernels, hold each
against its plain version, drive the flagship SPML train step, report.

Run from the repository root (needs one CUDA card, nvcc and no network):

    python3 chip_smoke.py

Phases, each printing one line:
 1. device: the card's name and power limit, torch and CUDA versions;
 2. build: nvcc for sm_90a of every csrc/*.cu, one process each, in
    parallel, with the seconds it took and ptxas's register report;
 3. kernels: K1 (stats), K2 (dE) and K3 (dP) of the joint SegSort loss
    through their autograd.Function against the plain version, computed in
    float64 on the same float32 values, at N = 16384 / P = 2048 (full and
    ~20% fill, N not a multiple of the tile, all prototypes invalid, both
    kappa branches) and at the flagship N = 131072 / P = 6144 (plain
    version over row chunks);
 4. main path: the flagship configuration (panoptic_deeplab_101, crop 512,
    batch 8, 6x6 k-means x10, capacity 256, memory bank 2, sem_ann +
    sem_occ + img_sim with the fused joint loss, bf16 convolutions) from
    random weights of seed 0 on blobby synthetic labels: 3 warm-up and 10
    timed steps; every loss finite, segments formed, each kernel launched
    once per step; then each kernel timed at the main path's own inputs
    beside the plain version and its bound;
 5. the kernel list as one JSON line;
 6. the card's name and power limit (nvidia-smi), then the last line
    {"ok": true, "device": {...}}.

Any failed phase raises: the script exits non-zero and prints no result.
Tolerances: the six statistics rtol 1e-5 (float32 sums in another order,
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
STATS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNELS = {  # launch counter -> (name, line of the TPU kernel replaced)
    "joint_stats": ("segsort_joint_stats",
                    "spml_tpu/ops/pallas/segsort_loss.py:664"),
    "joint_grad_emb": ("segsort_joint_grad_emb",
                       "spml_tpu/ops/pallas/segsort_loss.py:716"),
    "joint_grad_proto": ("segsort_joint_grad_proto",
                         "spml_tpu/ops/pallas/segsort_loss.py:716"),
}


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
                               device="cuda")

    f32, i32 = torch.float32, torch.int32
    return dict(emb=cuda(emb, f32), pix_lab=cuda(lab, i32),
                own_idx=cuda(own, i32), pix_tags=cuda(tag, i32),
                protos=cuda(protos, f32), proto_lab=cuda(plab, i32),
                proto_tags=cuda(ptag, i32), proto_valid=cuda(pval, i32),
                num_valid=cuda([nv], i32))


def reference64(torch, fused, case, grads, kappas, rows=16384):
    """Plain version in float64 over row chunks: stats, dE, dP."""
    stats, d_emb = [], []
    d_protos = torch.zeros_like(case["protos"], dtype=torch.float64)
    n = case["emb"].shape[0]
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        e = case["emb"][r0:r1].double().requires_grad_(True)
        p = case["protos"].double().requires_grad_(True)
        s = fused.joint_segsort_stats_reference(
            e, case["pix_lab"][r0:r1], case["own_idx"][r0:r1],
            case["pix_tags"][r0:r1], p, case["proto_lab"],
            case["proto_tags"], case["proto_valid"], case["num_valid"],
            *kappas)
        ge, gp = torch.autograd.grad((s * grads[:, r0:r1].double()).sum(),
                                     (e, p))
        stats.append(s.detach())
        d_emb.append(ge)
        d_protos += gp
    return torch.cat(stats, 1), torch.cat(d_emb), d_protos


def kernel_outputs(torch, fused, case, grads, kappas):
    e = case["emb"].clone().requires_grad_(True)
    p = case["protos"].clone().requires_grad_(True)
    s = fused.joint_segsort_stats(
        e, case["pix_lab"], case["own_idx"], case["pix_tags"], p,
        case["proto_lab"], case["proto_tags"], case["proto_valid"],
        case["num_valid"], *kappas)
    s.backward(grads)
    torch.cuda.synchronize()
    return s.detach(), e.grad, p.grad


def check_case(torch, fused, label, case, kappas, seed):
    n = case["emb"].shape[0]
    g = torch.randn(6, n, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    s, de, dp = kernel_outputs(torch, fused, case, g, kappas)
    rs, rde, rdp = reference64(torch, fused, case, g, kappas)
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
    log("kernels", f"{label}: N={n} P={case['protos'].shape[0]} "
        f"valid={int(case['num_valid'])} kappa={kappas} max_abs_err "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + " | tolerance used "
        + " ".join(f"{k}={v:.3f}" for k, v in margins.items()) + " ok")
    return errs


def check_kernels(torch, fused):
    mid = 16384
    cases = [("mid full fill", make_case(torch, mid, 2048, 1.0, 1),
              (6.0, 12.0)),
             ("mid 20% fill", make_case(torch, mid, 2048, 0.2, 2),
              (6.0, 12.0)),
             ("mid ragged N, two exps", make_case(torch, mid - 1, 2048, 0.2,
                                                  3), (6.0, 10.0)),
             ("mid all invalid", make_case(torch, mid, 2048, 0.0, 4),
              (6.0, 12.0)),
             ("flagship 17% fill", make_case(torch, 131072, 6144, 0.17, 5),
              (6.0, 12.0))]
    errs = {}
    for i, (label, case, kappas) in enumerate(cases):
        errs = check_case(torch, fused, label, case, kappas, seed=i)
    return errs  # the flagship case's


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def run_main_path(torch, fused):
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.train import flagship, step as step_lib

    cfg = load_config(overrides=flagship.OVERRIDES)
    b, crop = cfg.train.batch_size, cfg.train.crop_size[0]
    batch = flagship.blobby_batch(b, crop, cfg.dataset.num_classes)
    t0 = time.perf_counter()
    state = step_lib.init_state(cfg, 0, batch["image"], device="cuda")
    train_step = step_lib.make_train_step(cfg)
    log("main", f"state built in {time.perf_counter() - t0:.1f} s")

    last = {}
    orig = fused.joint_segsort_stats

    def recording(*args):  # keeps the last call's inputs for the timings
        last["args"] = [a.detach() if torch.is_tensor(a) else a
                        for a in args]
        return orig(*args)

    fused.joint_segsort_stats = recording
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
        fused.joint_segsort_stats = orig
    launches = dict(fused.LAUNCHES)

    steps = len(metrics_log)
    losses = [float(m["loss"]) for m in metrics_log]
    nsegs = [int(m["num_segments"]) for m in metrics_log]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if min(nsegs) <= 0:
        raise AssertionError(f"no segments formed: {nsegs}")
    for key in KERNELS:
        if launches[key] != steps:
            raise AssertionError(f"{key} launched {launches[key]} times in "
                                 f"{steps} steps, want once per step")
    ms = start.elapsed_time(end) / 10
    cap = b * cfg.tpu.segment_capacity
    log("main", f"{steps} steps, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, segments {nsegs[-1]}/{cap} "
        f"({nsegs[-1] / cap:.1%} of capacity), accuracy step 0 "
        f"{float(metrics_log[0]['accuracy']):.4f}")
    log("main", f"train step {ms:.2f} ms (CUDA events; host clock "
        f"{host_s * 100:.2f} ms), {b * 1000 / ms:.2f} imgs/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}, card {nvidia_smi_line()}")
    return launches, last["args"]


# ---------------------------------------------------------------------------
# Timings at the main path's inputs
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


def bounds(n, p, nv, d):
    """(bound_ms, bound_by) per kernel from this run's shapes: bytes each
    input read once and each output written once (prototype rows up to the
    valid count), operations per live (pixel, prototype) pair."""
    pairs = n * nv
    protos_in = nv * (d * 4 + 3 * 4)
    pix_in = n * (d * 4 + 3 * 4)
    work = {  # bytes, operations
        "joint_stats": (pix_in + protos_in + 6 * n * 4,
                        pairs * (2 * d + 10)),   # dot, 2 exps, 6 sums
        "joint_grad_emb": (pix_in + 6 * n * 4 + protos_in + n * d * 4,
                           pairs * (4 * d + 14)),  # dot, c, c*P[k]
        "joint_grad_proto": (pix_in + 6 * n * 4 + protos_in + p * d * 4,
                             pairs * (4 * d + 14)),
    }
    out = {}
    for key, (nbytes, ops) in work.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        out[key] = ((t_ops, "operations") if t_ops >= t_bytes
                    else (t_bytes, "bytes"))
    return out


def time_kernels(torch, fused, args):
    (emb, pix_lab, own, pix_tags, protos, proto_lab, proto_tags,
     proto_valid, num_valid, kappa_a, kappa_o) = args
    f32, i32 = torch.float32, torch.int32
    inputs = tuple(fused._kernel_operand(t, dt) for t, dt in (
        (emb, f32), (pix_lab, i32), (own, i32), (pix_tags, i32),
        (protos, f32), (proto_lab, i32), (proto_tags, i32),
        (proto_valid, i32), (num_valid, i32)))
    n, d = emb.shape
    p = protos.shape[0]
    nv = int(num_valid)
    grads = torch.randn(6, n, device="cuda")
    kernel_ms = {
        "joint_stats": cuda_time(
            torch, lambda: fused._launch_stats(inputs, kappa_a, kappa_o), 20),
        "joint_grad_emb": cuda_time(
            torch, lambda: fused._launch_grad_emb(inputs, kappa_a, kappa_o,
                                                  grads), 20),
        "joint_grad_proto": cuda_time(
            torch, lambda: fused._launch_grad_proto(inputs, kappa_a,
                                                    kappa_o, grads), 20),
    }

    rows = 32768  # the plain version over row chunks (it is [N, P] dense)

    def plain(kind):
        for r0 in range(0, n, rows):
            sl = slice(r0, min(r0 + rows, n))
            e = inputs[0][sl].detach().requires_grad_(kind == "dE")
            pr = inputs[4].detach().requires_grad_(kind == "dP")
            s = fused.joint_segsort_stats_reference(
                e, inputs[1][sl], inputs[2][sl], inputs[3][sl], pr,
                *inputs[5:], kappa_a, kappa_o)
            if kind != "stats":
                torch.autograd.grad((s * grads[:, sl]).sum(),
                                    e if kind == "dE" else pr)

    plain_ms = {"joint_stats": cuda_time(torch, lambda: plain("stats"), 3),
                "joint_grad_emb": cuda_time(torch, lambda: plain("dE"), 3),
                "joint_grad_proto": cuda_time(torch, lambda: plain("dP"), 3)}
    bnd = bounds(n, p, nv, d)
    for key in KERNELS:
        log("timing", f"{KERNELS[key][0]}: N={n} P={p} valid={nv} D={d} "
            f"kernel {kernel_ms[key]:.4f} ms, plain {plain_ms[key]:.3f} ms,"
            f" bound {bnd[key][0]:.4f} ms ({bnd[key][1]})")
    return kernel_ms, plain_ms, bnd


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
    launches, args = run_main_path(torch, fused)
    kernel_ms, plain_ms, bnd = time_kernels(torch, fused, args)

    err_of = {"joint_stats": errs["stats"], "joint_grad_emb": errs["dE"],
              "joint_grad_proto": errs["dP"]}
    table = [{"name": KERNELS[k][0], "route": "cuda",
              "source": "spml_tpu_torch/csrc/segsort_joint.cu",
              "replaces": KERNELS[k][1], "launches": launches[k],
              "max_abs_err": err_of[k], "ms": kernel_ms[k],
              "plain_ms": plain_ms[k], "bound_ms": bnd[k][0],
              "bound_by": bnd[k][1], "library_ms": None}
             for k in KERNELS]
    print(json.dumps({"kernels": table}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
