#!/usr/bin/env python3
"""The port on one CUDA card, end to end: build the kernels, hold each
against its plain version, drive the three ported SPML train steps and the
dilated-conv probe, report.

Run from the repository root (needs one CUDA card, nvcc and no network):

    python3 chip_smoke.py
    python3 chip_smoke.py --csrc OTHER/spml_tpu_torch/csrc

The second form builds another checkout's kernel sources (say, a parent
commit's; their C signatures must be this checkout's) and runs them
under this script's checks and timings, for an A/B in one call.

Phases, each printing one line or more:
 1. device: the card's name and power limit, torch and CUDA versions;
 2. build: nvcc for sm_90a of every csrc/*.cu, one process each, in
    parallel, with the seconds it took, ptxas's registers and spilled
    bytes for each kernel, and any ptxas line on wgmma or a performance
    loss (a serialized wgmma shows there); a spill in a tiled kernel
    (stats_tile_kernel, grad_tile_kernel) fails the run, and so does a
    per-row stats_kernel in this checkout's sources;
 3. kernels: each SegSort kernel family through its autograd.Function
    against the plain version, computed in float64 on the same float32
    values (plain version over row chunks). Every SegSort kernel is
    tiled: a block of 128 threads owns 128 rows and walks 64-row tiles of
    the other side, the products on the tensor cores in split TF32; dE
    skips the warps of 32 pixels none of which carries a nonzero
    cotangent, and the blocks with no such warp; the dP grid of 264
    blocks is split on the card into valid prototype tiles x pixel
    chunks. Cotangents are randn on every row but in the cases that say
    otherwise: each family also takes them on ~0.5% of the rows in short
    runs, on none (dE and dP must then be exactly 0) and on the last row
    of a ragged N alone, and the hard family at DensePose's 139 valid
    rows on 354 rows in runs, the path's own sparsity; dE must be exactly
    0 on every row without one.
    - joint, K1 (stats), K2 (dE), K3 (dP): at N = 16384 / P = 2048,
      D = 64 (full and ~20% fill, N not a multiple of the tile, all
      prototypes invalid, one valid, both kappa branches) and D = 32 (~20%
      fill), and at the flagship N = 131072 / P = 6144, D = 64;
    - hard labels, K4 (stats), K5 (dE), K6 (dP): at N = 16384 / P = 2048,
      D = 32 (full and ~20% fill, ragged N, all invalid, one valid, 64
      and 65 valid: the last prototype tile one full tile or one row) and
      D = 64, and at the DensePose N = 65536 / P = 2048, D = 32, ~15% fill
      and 139 valid rows, the path's own (K6's second prototype tile: 11
      live rows, three warps skipping);
    - tag sets, K7 (stats), K8 (dE), K9 (dP): at N = 16384 / P = 2048,
      D = 64 (full and ~20% fill, ragged N, all invalid, one valid: one
      live prototype tile over 264 pixel chunks) and D = 32, and at
      the tag step's N = 65536 / P = 3072, D = 64, ~20% fill; one to three
      tags of 20 per row, a tenth of the rows below the valid count
      invalid (their own mask still counts);
    - the dilated conv K10 against its plain version in float64 on the
      same bf16 values: ragged shapes at d = 1, 2, 4 (B = 1, H and W not
      multiples of the 8 x 16 tile, C = 16 and 48 under a 64-channel box,
      O = 16 and 144 filling part of a 256-channel tile), a 3 x 3 image
      at d = 4 where every tap but the centre lies outside, two channel
      chunks with two N tiles, and the probe's two shapes (B = 8,
      64 x 64, 256 -> 256 at d = 2, 512 -> 512 at d = 4);
 4. main paths, each from random weights of seed 0, 3 warm-up and 10
    timed steps, every loss finite, segments formed, each of its kernels
    launched once per step and the other families' not at all; then each
    kernel timed at the path's own inputs beside the plain version and its
    bound (every SegSort kernel: at the split-TF32 rate its products use,
    with the float32 bound beside it as bound_f32_ms); dE and dP on randn
    cotangents, and again on the cotangents the path's last backward
    handed them (path_cotangent_ms, beside a bound that counts only the
    pixels carrying a nonzero one):
    - flagship (panoptic_deeplab_101, crop 512, batch 8, 6x6 k-means x10,
      capacity 256, memory bank 2, sem_ann + sem_occ + img_sim with the
      fused joint loss, bf16 convolutions) on blobby synthetic labels:
      K1-K3;
    - DensePose point (panoptic_pspnet_101_densepose, dim 32, crop 512,
      batch 4, 12x12 k-means x10, capacity 512, no memory bank, sem_ann
      + img_sim with the fused hard-label loss, bf16 convolutions) on
      synthetic point labels, with labelled pixels in the loss: K4-K6;
    - VOC image tags, tags only (the flagship network at batch 4, sem_ann
      off, sem_occ + img_sim with the fused tag-set loss) on the flagship's
      blobby labels: K7-K9;
    - the dilated-conv probe (spml_tpu_torch/tools/dilated_conv_probe.py)
      at its two shapes: K10, then K10 timed at the first shape (res4 d2)
      beside its plain version, cuDNN (F.conv2d, the library yardstick)
      and its bound at the bf16 tensor-core peak;
 5. the kernel list as one JSON line;
 6. the card's name and power limit (nvidia-smi), then the last line
    {"ok": true, "device": {...}}.

Any failed phase raises: the script exits non-zero and prints no result.
Tolerances: the SegSort statistics rtol 1e-5 (float32 sums in another
order, amplified by exp(kappa * logit)); dE and dP rtol 1e-4 with atol
1e-5 * max|reference|; the dilated conv rtol 2^-8 (one bf16 rounding of
the output) with atol 1e-3 * max|reference| (float32 sums of 9 C terms
that cancel near zero).
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"  # every tensor of the run lives here
STATS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
CONV_RTOL, CONV_ATOL_REL = 2.0 ** -8, 1e-3
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, dense
# bf16 on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PALLAS = "spml_tpu/ops/pallas/segsort_loss.py"
PROBE = "pyscripts/misc/pallas_dilated_conv_probe.py"
SEGSORT_SOURCE = "spml_tpu_torch/csrc/segsort_joint.cu"
KERNELS = {  # launch counter -> (name, line of the TPU kernel replaced)
    "joint_stats": ("segsort_joint_stats", f"{PALLAS}:664"),
    "joint_grad_emb": ("segsort_joint_grad_emb", f"{PALLAS}:716"),
    "joint_grad_proto": ("segsort_joint_grad_proto", f"{PALLAS}:716"),
    "hard_stats": ("segsort_hard_stats", f"{PALLAS}:130"),
    "hard_grad_emb": ("segsort_hard_grad_emb", f"{PALLAS}:200"),
    "hard_grad_proto": ("segsort_hard_grad_proto", f"{PALLAS}:240"),
    "set_stats": ("segsort_set_stats", f"{PALLAS}:408"),
    "set_grad_emb": ("segsort_set_grad_emb", f"{PALLAS}:444"),
    "set_grad_proto": ("segsort_set_grad_proto", f"{PALLAS}:444"),
}
# kernels whose D-long products run on the tensor cores in split TF32
TENSOR_CORE = ("joint_stats", "joint_grad_emb", "joint_grad_proto",
               "hard_stats", "hard_grad_emb", "hard_grad_proto",
               "set_stats", "set_grad_emb", "set_grad_proto")
# the tiled SegSort kernels: a spill in any of them fails the build phase
TILED_KERNELS = ("stats_tile_kernel", "grad_tile_kernel")
PER_ROW_KERNEL = "stats_kernel<"  # retired: fails the build phase
CONV_KERNEL = ("dilated_conv3x3_bf16", f"{PROBE}:31",
               "spml_tpu_torch/csrc/dilated_conv.cu")
KINDS = ("stats", "grad_emb", "grad_proto")
N_STATS = {"joint": 6, "hard": 3, "set": 3}
N_KAPPAS = {"joint": 2, "hard": 1, "set": 1}
# recipe (spml_tpu_torch/train/recipes.py) -> family of its loss kernels
RECIPE_FAMILY = {"flagship": "joint", "densepose_point": "hard",
                 "voc_tag": "set"}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def kernel_name(mangled):
    """A kernel's name and integer template arguments from its mangled
    name (grad_tile_kernel<64,0,1>); other names as they are."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)  # anonymous namespace
    if not m:
        return mangled
    rest = mangled[m.end(1) + int(m.group(1)):]
    m = re.match(r"\d+", rest)
    end = m.end() + int(m.group(0))
    name, args = rest[m.end():end], re.match(r"I((?:L[a-z]+\d+E)+)E",
                                             rest[end:])
    if args:
        name += "<" + ",".join(re.findall(r"L[a-z]+(\d+)E", args.group(1))) \
            + ">"
    return name


def ptxas_kernels(report):
    """[(kernel, registers, spilled bytes stored + loaded)] of a ptxas -v
    report."""
    out, name, spill = [], None, 0
    for ln in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            name, spill = kernel_name(m.group(1)), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", ln):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

def make_case(torch, n, p, fill, seed, d=64, n_classes=21, n_tags=20,
              sparse_tags=False):
    """Inputs of the SegSort kernels as the wrapper hands them over:
    prototypes sorted valid-first, pixels near their own prototype.
    sparse_tags (the set family's cases): one to three tags per row, as
    images carry, a sixth of the prototypes tagless, and a tenth of the
    rows below the valid count invalid (touched only as an own
    prototype)."""
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
    if sparse_tags:
        def few_tags(k):
            bits = [1 << rng.randint(0, n_tags, k) for _ in range(3)]
            return np.where(rng.rand(k) < 0.5, bits[0], 0) | \
                np.where(rng.rand(k) < 0.3, bits[1], 0) | bits[2]
        ptag = np.where(rng.rand(p) < 1 / 6, 0, few_tags(p))
        tag = np.where(rng.rand(n) < 0.7, ptag[own], few_tags(n))
        pval[rng.rand(p) < 0.1] = 0

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
    if family == "set":
        return [emb, c["pix_tags"][rows], c["own_idx"][rows], protos,
                c["proto_tags"], c["proto_valid"], c["num_valid"]]
    return [emb, c["pix_lab"][rows], c["own_idx"][rows], protos,
            c["proto_lab"], c["num_valid"]]


STATS_FN = {"joint": "joint_segsort_stats", "hard": "segsort_stats",
            "set": "set_segsort_stats"}


def stats_fns(fused, family):
    """(kernel path, plain version) of a family."""
    name = STATS_FN[family]
    return getattr(fused, name), getattr(fused, name + "_reference")


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


def carrying_rows(n, kind, seed):
    """[N] bool, the rows given a nonzero cotangent: every row ("randn");
    short runs of 1 to 3 rows at random starts over ~0.5% of the rows
    ("runs"), or over 354 rows ("densepose"), as the DensePose step's
    labelled points fall; none ("zero"); the last row alone ("last")."""
    rows = np.zeros(n, bool)
    if kind == "randn":
        rows[:] = True
    elif kind == "last":
        rows[-1] = True
    elif kind in ("runs", "densepose"):
        want = 354 if kind == "densepose" else round(0.005 * n)
        rng = np.random.RandomState(seed)
        while rows.sum() < want:
            start = rng.randint(0, n)
            rows[start:start + min(rng.randint(1, 4), want - rows.sum())] \
                = True
    elif kind != "zero":
        raise ValueError(kind)
    return rows


def check_case(torch, fused, family, label, case, kappas, seed,
               cotangents="randn"):
    """The family's three kernels on one case, against the plain version;
    the cotangents are randn on the rows of carrying_rows(cotangents), 0
    on the others, whose dE rows must then be exactly 0 (dE and dP both
    when no row carries one)."""
    n = case["emb"].shape[0]
    g = torch.randn(N_STATS[family], n, device=DEVICE,
                    generator=torch.Generator(DEVICE).manual_seed(seed))
    carries = torch.as_tensor(carrying_rows(n, cotangents, seed),
                              device=DEVICE)
    g = torch.where(carries, g, 0.0)
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
    if not (de[~carries] == 0).all():
        raise AssertionError(f"{label}: dE not exactly 0 on a row without a "
                             "cotangent")
    if not carries.any() and not (dp == 0).all():
        raise AssertionError(f"{label}: dP not exactly 0 under zero "
                             "cotangents")
    log("kernels", f"{family} {label}: N={n} P={case['protos'].shape[0]} "
        f"D={case['emb'].shape[1]} valid={int(case['num_valid'])} "
        f"kappa={kappas} rows with a cotangent {int(carries.sum())} "
        "max_abs_err "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + " | tolerance used "
        + " ".join(f"{k}={v:.3f}" for k, v in margins.items()) + " ok")
    return errs


def check_kernels(torch, fused):
    """Every family's cases; returns {family: errors of its main-path
    sized case on randn cotangents (the last)}. A fourth element names the
    cotangents' rows (carrying_rows; randn on all by default)."""
    mid = 16384
    cases = {
        "joint": [
            ("mid full fill", (mid, 2048, 1.0, 1, 64), (6.0, 12.0)),
            ("mid 20% fill", (mid, 2048, 0.2, 2, 64), (6.0, 12.0)),
            ("mid ragged N, two exps", (mid - 1, 2048, 0.2, 3, 64),
             (6.0, 10.0)),
            ("mid all invalid", (mid, 2048, 0.0, 4, 64), (6.0, 12.0)),
            ("mid one valid, two exps", (mid, 2048, 1 / 2048, 7, 64),
             (6.0, 10.0)),
            ("mid 20% fill", (mid, 2048, 0.2, 6, 32), (6.0, 12.0)),
            ("mid 20% fill, 0.5% of rows in runs", (mid, 2048, 0.2, 8, 64),
             (6.0, 12.0), "runs"),
            ("mid 20% fill, zero cotangents", (mid, 2048, 0.2, 9, 64),
             (6.0, 12.0), "zero"),
            ("mid ragged N, last row only", (mid - 1, 2048, 0.2, 10, 64),
             (6.0, 10.0), "last"),
            ("flagship 17% fill", (131072, 6144, 0.17, 5, 64),
             (6.0, 12.0))],
        "hard": [
            ("mid full fill", (mid, 2048, 1.0, 11, 32), (6.0,)),
            ("mid 20% fill", (mid, 2048, 0.2, 12, 32), (6.0,)),
            ("mid ragged N", (mid - 1, 2048, 0.2, 13, 32), (6.0,)),
            ("mid all invalid", (mid, 2048, 0.0, 14, 32), (6.0,)),
            ("mid one valid", (mid, 2048, 1 / 2048, 17, 32), (6.0,)),
            ("mid 64 valid, one full prototype tile",
             (mid, 2048, 64 / 2048, 33, 32), (6.0,)),
            ("mid 65 valid, one row in the last prototype tile",
             (mid, 2048, 65 / 2048, 34, 32), (6.0,)),
            ("mid 20% fill", (mid, 2048, 0.2, 15, 64), (6.0,)),
            ("DensePose 15% fill", (65536, 2048, 0.15, 16, 32), (6.0,)),
            ("mid 20% fill, 0.5% of rows in runs", (mid, 2048, 0.2, 19, 32),
             (6.0,), "runs"),
            ("mid 20% fill, zero cotangents", (mid, 2048, 0.2, 20, 32),
             (6.0,), "zero"),
            ("mid ragged N, last row only", (mid - 1, 2048, 0.2, 28, 32),
             (6.0,), "last"),
            ("DensePose 139 valid, 354 rows in runs",
             (65536, 2048, 139 / 2048, 29, 32), (6.0,), "densepose"),
            ("DensePose 139 valid", (65536, 2048, 139 / 2048, 18, 32),
             (6.0,))],
        "set": [
            ("mid full fill", (mid, 2048, 1.0, 21, 64), (8.0,)),
            ("mid 20% fill", (mid, 2048, 0.2, 22, 64), (8.0,)),
            ("mid ragged N", (mid - 1, 2048, 0.2, 23, 64), (8.0,)),
            ("mid all invalid", (mid, 2048, 0.0, 24, 64), (8.0,)),
            ("mid one valid", (mid, 2048, 1 / 2048, 27, 64), (8.0,)),
            ("mid 20% fill", (mid, 2048, 0.2, 25, 32), (8.0,)),
            ("mid 20% fill, 0.5% of rows in runs", (mid, 2048, 0.2, 30, 64),
             (8.0,), "runs"),
            ("mid 20% fill, zero cotangents", (mid, 2048, 0.2, 31, 64),
             (8.0,), "zero"),
            ("mid ragged N, last row only", (mid - 1, 2048, 0.2, 32, 64),
             (8.0,), "last"),
            ("tag step 20% fill", (65536, 3072, 0.2, 26, 64), (8.0,))],
    }
    errs = {}
    for family, family_cases in cases.items():
        for label, (n, p, fill, seed, d), kappas, *cotangents in \
                family_cases:
            case = make_case(torch, n, p, fill, seed, d=d,
                             sparse_tags=family == "set")
            errs[family] = check_case(torch, fused, family, label, case,
                                      kappas, seed, *cotangents)
    return errs


# ---------------------------------------------------------------------------
# Main paths
# ---------------------------------------------------------------------------

def run_main_path(torch, fused, recipe):
    """3 warm-up and 10 timed steps of one recipe; returns (launch counts,
    the last call's stats inputs, the cotangent of its stats that the last
    backward handed to the kernels)."""
    from spml_tpu_torch.train import recipes
    from spml_tpu_torch.train import step as step_lib

    cfg, batch = recipes.setup(recipe, device=DEVICE)
    family = RECIPE_FAMILY[recipe]
    b = cfg.train.batch_size
    t0 = time.perf_counter()
    state = step_lib.init_state(cfg, 0, batch["image"], device=DEVICE)
    train_step = step_lib.make_train_step(cfg)
    log(recipe, f"state built in {time.perf_counter() - t0:.1f} s")

    last, masked = {}, []
    stats_name = STATS_FN[family]
    orig_stats, orig_ll = getattr(fused, stats_name), fused._ll_from_stats

    def keep_cotangent(g):
        last["grads"] = g.detach().clone()

    def recording(*args):  # keeps the last call's inputs for the timings
        last["args"] = [a.detach() if torch.is_tensor(a) else a
                        for a in args]
        stats = orig_stats(*args)
        stats.register_hook(keep_cotangent)
        return stats

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
    carrying = int((last["grads"] != 0).any(0).sum())
    log(recipe, f"{steps} steps, loss {loss[0]:.4f} -> {loss[-1]:.4f} ("
        + ", ".join(f"{k} {v[-1]:.4f}" for k, v in losses.items()
                    if k != "loss")
        + f"), segments {nsegs[-1]}/{cap} ({nsegs[-1] / cap:.1%} of "
        f"capacity), loss pixels {int(masked[-1])}, pixels with a nonzero "
        f"stats cotangent {carrying} of {last['grads'].shape[1]}, kernel "
        f"valid count {int(last['args'][-1 - N_KAPPAS[family]])}, accuracy "
        f"step 0 {float(metrics_log[0]['accuracy']):.4f}")
    log(recipe, f"train step {ms:.2f} ms (CUDA events; host clock "
        f"{host_s * 100:.2f} ms), {b * 1000 / ms:.2f} imgs/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{launches}, card {nvidia_smi_line()}")
    return launches, last["args"], last["grads"]


# ---------------------------------------------------------------------------
# Timings at the main paths' inputs
# ---------------------------------------------------------------------------

def bounds(family, n, p, nv, d, rows=None):
    """{kind: (bound_ms, bound_by, float32 bound ms)} of a family from this
    run's shapes: bytes each input read once and each output written once
    (prototype rows up to the valid count), operations per live (pixel,
    prototype) pair at the float32 peak; for the kernels whose products
    run on the tensor cores in split TF32 (TENSOR_CORE), the product flops
    a pair (2 D for the stats, 4 D for dE and dP) three times at the TF32
    peak plus the rest at the float32 peak. rows: the pixels whose pairs
    the gradients need, those with a nonzero cotangent (all N by
    default); the gradients' pairs and pixel operands count only these,
    their cotangents and outputs in full."""
    rows = n if rows is None else rows
    ns = N_STATS[family]
    if family == "joint":  # rows carry label, own / tag, valid
        pix_row, proto_row = d * 4 + 3 * 4, d * 4 + 3 * 4
        ops_stats, ops_grad = 2 * d + 10, 4 * d + 14  # 2 exps, 6 sums
    elif family == "set":  # rows carry tag bitword, own / bitword, valid
        pix_row, proto_row = d * 4 + 8, d * 4 + 8
        ops_stats, ops_grad = 2 * d + 7, 4 * d + 9  # 1 exp, 3 sums, 1 AND
    else:  # rows carry label, own / label
        pix_row, proto_row = d * 4 + 8, d * 4 + 4
        ops_stats, ops_grad = 2 * d + 6, 4 * d + 8
    protos_in, grads_in = nv * proto_row, ns * n * 4
    work = {  # bytes, operations a pair, product flops a pair, pairs
        "stats": (n * pix_row + protos_in + ns * n * 4, ops_stats, 2 * d,
                  n * nv),
        "grad_emb": (rows * pix_row + grads_in + protos_in + n * d * 4,
                     ops_grad, 4 * d, rows * nv),
        "grad_proto": (rows * pix_row + grads_in + protos_in + p * d * 4,
                       ops_grad, 4 * d, rows * nv),
    }
    out = {}
    for kind, (nbytes, ops, prod, pairs) in work.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_f32 = pairs * ops / PEAK_F32_FLOPS * 1e3
        t_ops = t_f32
        if f"{family}_{kind}" in TENSOR_CORE:
            t_ops = pairs * (3 * prod / PEAK_TF32_FLOPS
                             + (ops - prod) / PEAK_F32_FLOPS) * 1e3
        out[kind] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes")) + (max(t_f32, t_bytes),)
    return out


def time_kernels(torch, fused, family, args, path_grads):
    """Each kernel of a family at a main path's last inputs (CUDA events,
    20 launches) beside the plain version (3 runs over row chunks) and
    its bound, dE and dP on randn cotangents and again on path_grads, the
    cotangents the path's last backward handed them (its bound counting
    only the rows that carry one); returns {counter: (ms, plain ms,
    (bound ms, by, float32 bound ms), (path ms, path bound, rows) or
    None)}."""
    from spml_tpu_torch.tools.dilated_conv_probe import cuda_ms

    ns, nk = N_STATS[family], N_KAPPAS[family]
    tensors, kappas = args[:-nk], tuple(args[-nk:])
    scalars = kappas  # as the C functions take them
    if family == "joint":
        scalars = (*kappas, int(kappas[1] == 2.0 * kappas[0]))
    f32, i32 = torch.float32, torch.int32
    at = fused._FAMILIES[family][1]  # the prototypes among the inputs
    inputs = tuple(fused._kernel_operand(t, f32 if i in (0, at) else i32)
                   for i, t in enumerate(tensors))
    emb, protos = inputs[0], inputs[at]
    n, d = emb.shape
    p = protos.shape[0]
    nv = int(inputs[-1])
    grads = torch.randn(ns, n, device=DEVICE)
    path_grads = fused._kernel_operand(path_grads, f32)
    carrying = int((path_grads != 0).any(0).sum())

    def grad_ms(kind, g):
        launch = getattr(fused, f"_launch_{kind}")
        return cuda_ms(lambda: launch(family, inputs, scalars, g), 20)

    kernel_ms = {
        "stats": cuda_ms(
            lambda: fused._launch_stats(family, inputs, scalars), 20),
        "grad_emb": grad_ms("grad_emb", grads),
        "grad_proto": grad_ms("grad_proto", grads),
    }
    path_ms = {kind: grad_ms(kind, path_grads)
               for kind in ("grad_emb", "grad_proto")}

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

    plain_ms = {kind: cuda_ms(lambda: plain(kind), 3)
                for kind in KINDS}
    bnd = bounds(family, n, p, nv, d)
    path_bnd = bounds(family, n, p, nv, d, carrying)
    out = {}
    for kind in KINDS:
        key = f"{family}_{kind}"
        path = None
        if kind in path_ms:
            path = (path_ms[kind], path_bnd[kind], carrying)
        out[key] = (kernel_ms[kind], plain_ms[kind], bnd[kind], path)
        log("timing", f"{KERNELS[key][0]}: N={n} P={p} valid={nv} D={d} "
            f"kernel {kernel_ms[kind]:.4f} ms, plain {plain_ms[kind]:.3f} "
            f"ms, bound {bnd[kind][0]:.4f} ms ({bnd[kind][1]}; float32 "
            f"{bnd[kind][2]:.4f} ms)" + ("" if path is None else
            f"; on the path's cotangents ({carrying} rows carry one) kernel "
            f"{path[0]:.4f} ms, bound {path[1][0]:.4f} ms ({path[1][1]}; "
            f"float32 {path[1][2]:.4f} ms)"))
    return out


# ---------------------------------------------------------------------------
# The dilated conv K10
# ---------------------------------------------------------------------------

def check_dilated_conv(torch, dc):
    """K10 against its plain version in float64 on the same bf16 values;
    returns the largest absolute error at the probe's shapes."""
    from spml_tpu_torch.tools.dilated_conv_probe import SHAPES

    gen = torch.Generator(DEVICE).manual_seed(0)
    cases = [("ragged d1", 2, 9, 7, 16, 32, 1),
             ("ragged d2 C 48 O 16", 3, 13, 20, 48, 16, 2),
             ("ragged d4 B 1 O 144", 1, 6, 33, 32, 144, 4),
             ("taps outside but the centre", 1, 3, 3, 16, 16, 4),
             ("two chunks, two N tiles", 1, 10, 17, 80, 272, 3),
             ("B 1 C 48 O 400", 1, 17, 23, 48, 400, 2)]
    probe_err = 0.0
    for label, b, h, w, c, o, d in cases + SHAPES:
        x = torch.randn(b, h, w, c, device=DEVICE, generator=gen).bfloat16()
        wt = (0.05 * torch.randn(3, 3, c, o, device=DEVICE,
                                 generator=gen)).bfloat16()
        got = dc.dilated_conv3x3(x, wt, d)
        torch.cuda.synchronize()
        ref = dc.dilated_conv3x3_reference(x.double(), wt.double(), d)
        if got.dtype != torch.bfloat16 or not torch.isfinite(got).all():
            raise AssertionError(f"dilated conv {label}: bad output")
        abs_tol = CONV_ATOL_REL * float(ref.abs().max())
        torch.testing.assert_close(got.double(), ref, rtol=CONV_RTOL,
                                   atol=abs_tol,
                                   msg=lambda m: f"dilated conv {label}: {m}")
        err = (got.double() - ref).abs()
        margin = float((err / (abs_tol + CONV_RTOL * ref.abs())).max())
        if (label, b, h, w, c, o, d) in SHAPES:
            probe_err = max(probe_err, float(err.max()))
        log("kernels", f"dilated conv {label}: x [{b}, {h}, {w}, {c}] -> "
            f"{o}, d={d} max_abs_err {float(err.max()):.3e} | tolerance "
            f"used {margin:.3f} ok")
    return probe_err


def run_probe_path(torch, dc):
    """The dilated-conv probe's entry point at its two shapes; returns the
    launch count of that run."""
    from spml_tpu_torch.tools import dilated_conv_probe

    dc.reset_launch_counts()
    dilated_conv_probe.main()
    launches = dc.LAUNCHES["dilated_conv3x3"]
    # per shape: the error check, the warm-up call, ITERS timed calls
    want = len(dilated_conv_probe.SHAPES) * (2 + dilated_conv_probe.ITERS)
    if launches != want:
        raise AssertionError(f"probe: dilated_conv3x3 launched {launches} "
                             f"times, want {want}")
    return launches


def time_dilated_conv(torch, dc):
    """K10 at the probe's first shape (res4 d2) beside its plain version,
    cuDNN and its bound; returns (ms, plain ms, library ms, (bound ms,
    by))."""
    from spml_tpu_torch.tools.dilated_conv_probe import (
        SHAPES, cuda_ms, cudnn_conv, cudnn_weight)

    label, b, h, w, c, o, d = SHAPES[0]
    gen = torch.Generator(DEVICE).manual_seed(1)
    x = torch.randn(b, h, w, c, device=DEVICE, generator=gen).bfloat16()
    wt = (0.05 * torch.randn(3, 3, c, o, device=DEVICE,
                             generator=gen)).bfloat16()
    w_oihw = cudnn_weight(wt)
    ms = cuda_ms(lambda: dc.dilated_conv3x3(x, wt, d), 20)
    plain_ms = cuda_ms(lambda: dc.dilated_conv3x3_reference(x, wt, d), 5)
    library_ms = cuda_ms(lambda: cudnn_conv(x, w_oihw, d), 20)
    t_ops = 2 * b * h * w * c * o * 9 / PEAK_BF16_FLOPS * 1e3
    t_bytes = 2 * (b * h * w * (c + o) + 9 * c * o) / PEAK_BYTES * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                             "bytes")
    log("timing", f"dilated_conv3x3_bf16 ({label}): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, cuDNN {library_ms:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]})")
    return ms, plain_ms, library_ms, bound


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", help="build the kernels from this directory "
                    "in place of spml_tpu_torch/csrc")
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from spml_tpu_torch.ops import _cuda, dilated_conv as dc
    from spml_tpu_torch.ops import segsort_loss as fused

    if opts.csrc:
        _cuda.CSRC = Path(opts.csrc).resolve()
        log("build", f"kernel sources from {_cuda.CSRC}")
    smi = nvidia_smi_line()
    log("device", f"{smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = _cuda.build()
    kernels = {src: ptxas_kernels(r) for src, r in reports.items()}
    warnings = [f"{src}: {ln.strip()}" for src, r in reports.items()
                for ln in r.splitlines()
                if any(k in ln for k in ("wgmma", "Performance Loss"))]
    log("build", f"{len(reports)} source(s) in "
        f"{time.perf_counter() - t0:.1f} s; ptxas (registers, spilled "
        "bytes): " + " | ".join(f"{k} {regs} {spill}"
                                for ks in kernels.values()
                                for k, regs, spill in ks)
        + "".join(f" | {w}" for w in warnings))
    segsort = kernels.get("segsort_joint", [])
    tiled = [(k, spill) for k, _, spill in segsort
             if k.startswith(TILED_KERNELS)]
    spilled = [k for k, spill in tiled if spill]
    if spilled or {k.split("<")[0] for k, _ in tiled} != set(TILED_KERNELS):
        raise AssertionError(f"ptxas: tiled kernels spill or are missing: "
                             f"{spilled or tiled}")
    per_row = [k for k, _, _ in segsort if k.startswith(PER_ROW_KERNEL)]
    if per_row and not opts.csrc:  # another checkout's may still hold one
        raise AssertionError(f"ptxas: per-row kernels left: {per_row}")

    errs = check_kernels(torch, fused)
    conv_err = check_dilated_conv(torch, dc)
    launches, times = {}, {}
    for recipe, family in RECIPE_FAMILY.items():
        path_launches, args, path_grads = run_main_path(torch, fused,
                                                        recipe)
        launches.update({k: v for k, v in path_launches.items()
                         if k.startswith(family)})
        times.update(time_kernels(torch, fused, family, args, path_grads))
    conv_launches = run_probe_path(torch, dc)
    conv_ms, conv_plain, conv_lib, (conv_bound, conv_by) = \
        time_dilated_conv(torch, dc)

    err_name = {"stats": "stats", "grad_emb": "dE", "grad_proto": "dP"}
    table = []
    for key, (name, replaces) in KERNELS.items():
        family, kind = key.split("_", 1)
        ms, plain_ms, (bound_ms, bound_by, f32_ms), path = times[key]
        table.append({
            "name": name, "route": "cuda", "source": SEGSORT_SOURCE,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errs[family][err_name[kind]], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
        if key in TENSOR_CORE:  # the bound of the same work in float32
            table[-1]["bound_f32_ms"] = f32_ms
        if path is not None:  # dE, dP on the path's own cotangents
            path_ms, (path_bound, path_by, _), rows = path
            table[-1].update({"path_cotangent_ms": path_ms,
                              "path_cotangent_bound_ms": path_bound,
                              "path_cotangent_bound_by": path_by,
                              "path_cotangent_rows": rows})
    name, replaces, source = CONV_KERNEL
    table.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": conv_launches,
        "max_abs_err": conv_err, "ms": conv_ms, "plain_ms": conv_plain,
        "bound_ms": conv_bound, "bound_by": conv_by,
        "library_ms": conv_lib})
    print(json.dumps({"kernels": table}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
