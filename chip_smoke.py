#!/usr/bin/env python3
"""The port on one CUDA card, end to end: build the kernels, hold each
against its plain version, drive the three ported SPML train steps, the
dilated-conv probe, the single-scale KNN inference path, the training
drivers from an image list on disk and the self-training chain after
them (MSC, CRF, softmax inference, pseudo-labels), report.

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
 5. inference, the single-scale KNN path at VOC's test geometry
    (bashscripts/voc12/train_spml_scribble.sh:50-52, 82-100; no custom
    kernel on it): panoptic_deeplab_101 from random weights of seed 0
    (cli.build_eval_models without a snapshot; eval mode, bf16 convs),
    test.image_size 512, crop = stride = 512, 12x12 k-means x10, 21
    classes, top 20. build_prototypes on 8 blobby images (512 x 384 and
    384 x 512); a bank of 1,523,808 (VOC train_aug's 10,582 images x 144
    clusters): each built prototype 20 times, the rest random unit
    vectors with labels 0-20 (seed 0); predict_semantic on the same 8.
    Checks: (a) labels in [0, 21); (b) each prediction equals its own
    clusters' majority labels, but on clusters whose float64
    self-affinity lies within TIE_GAP of another prototype's; (c) on a
    fresh image, the top-20 labels equal a float64 recomputation on the
    card as multisets, but where the 20th and 21st float64 affinities
    lie within TIE_GAP, and the stages composed equal predict_semantic;
    then the device path against the CPU path in float32 (crop 128,
    stride 64, a 192 x 160 image: 2 x 2 windows): the stitched map within
    STITCH_RTOL, clusters, labels and predictions equal. One [inference]
    line: build and predict ms/image and images/s (CUDA events, 3
    warm-up and 10 timed images), the split of a prediction (upload,
    forward, stitch, kmeans, knn, vote), peak memory, the nvidia-smi
    line;
 6. driver, the train entry points as a user runs them, on a world of 24
    JPEGs (500 x 375 and 375 x 500) with blobby 21-class PNG labels
    (255 around each blob) and ~30 Voronoi segments each as instance
    maps, written from seed 0 (spml_tpu_torch/data/synthetic.py):
    - stage 1, train/driver.py::train_spml with ListTagDataset on the
      recipe of bashscripts/voc12/train_spml_scribble.sh:17-46
      (panoptic_deeplab_101, 64-d, bf16 convs, batch 4, crop 512,
      mirror / scale / crop, 4 loader threads, 6 x 6 k-means x 10,
      capacity 256, memory bank 2, kappa 6 / 12 / 16 with weights 1 /
      0.5 / 0.1, tpu.use_fused_loss on), 4 iterations with snapshot_step
      2, then again with train.resume to iteration 6: finite losses,
      K1-K3 launched once a step and no other kernel, the second call
      starting at step 4 at the schedule's LR of step 4, checkpoints 2,
      4 and 6; then K1-K3 on the stats inputs of step 6 (N = 65536,
      P = 3072, D = 64, kappa 6 / 12), on the cotangents its backward
      handed them and on randn ones, against the plain version as in
      phase 3;
    - the single-scale KNN chain on that snapshot (cli.build_eval_models
      reads the port checkpoint): run_prototype over 8 images,
      run_knn_inference over 4 (12 x 12 clusters), run_benchmark: the
      mIoU a finite number in [0, 1], the 4 PNGs written;
    - stage 2, train_classifier with ListTagClassifierDataset over the
      stage-1 snapshot (softmax_classifier, batch 16, crop 512, no
      k-means, 1 x 1 clusters; train_spml_scribble.sh:123-129), 12
      iterations: every embedding parameter and BN buffer equal to stage
      1's, every head parameter changed, finite losses, no kernel; and
      the two runs' loaders alone, ms a batch over 8 batches with no
      step running;
    - the baseline, train_spml with softmax_classifier and Adam, batch
      4, 12 iterations: no kernel, the memory bank empty, the stem and
      res2 unchanged and every res3-5 parameter changed, finite losses.
    For stages 1 and 2 and the baseline a [driver] line: the steady state
    over the steps after the first (each step call between CUDA events
    and a synchronize): host ms in the step call, the loader wait
    (next(loader)) ms, device ms, images/s; the same over the steps after
    the first 5 (after the 4 batches prefetched during the first step are
    used up) with the data-wait share, wait / (wait + step call); each
    step's wait, the first step; then the same step replayed on the
    run's last batch with the loader closed, timed the same way and back
    to back (as the recipes are); peak memory, the nvidia-smi line;
 7. selftrain, the VOC scribble recipe after stage 1
    (train_spml_scribble.sh:82-170) on the driver phase's world and
    snapshots, at full width (no custom kernel on it): (a)
    run_knn_inference on the stage-1 snapshot and bank over 4 images with
    MSC (scales 0.5-1.5 x flips) + CRF, and with MSC alone, whose labels
    must equal the float64 argmax of the very float32 sums it resized
    but at near-ties (MSC_TIE_GAP); (b) run_softmax_inference of the
    stage-2 snapshot with MSC + CRF and without; (c) run_pseudo_softmax
    (walk, CRF, scales (1.0,)) over the 24 images, run_benchmark on it,
    the list rewritten to the pseudo-labels as the recipe's sed does, 2
    steps of train_classifier on it; (d) run_pseudo_knn and
    run_pseudo_camrw_crf (CAMs from data/synthetic.py) over 4 images,
    run_pseudo_densepose over 2 point-labelled images on
    panoptic_pspnet_101_densepose from seed 0 weights; (e) the walk at a
    500 x 375 image's grid (n = 2852) against float64 on the card, the
    KNN and softmax pyramids against the CPU in float32 (crop 128, stride
    64, 192 x 160), the CRF twice equal, no SegSort or K10 launch in the
    phase; one [selftrain] line: ms/image of KNN MSC + CRF (device
    pyramid, float16 download, host CRF), of the softmax pyramid and of
    the pseudo-label step (forward, affinity, walk, CRF), peak memory,
    the nvidia-smi line;
 8. the kernel list as one JSON line;
 9. the card's name and power limit (nvidia-smi), then the last line
    {"ok": true, "device": {...}}.

Any failed phase raises: the script exits non-zero and prints no result.
Tolerances: the SegSort statistics rtol 1e-5 (float32 sums in another
order, amplified by exp(kappa * logit)); dE and dP rtol 1e-4 with atol
1e-5 * max|reference|; the dilated conv rtol 2^-8 (one bf16 rounding of
the output) with atol 1e-3 * max|reference| (float32 sums of 9 C terms
that cancel near zero); inference TIE_GAP 1e-5 (float32 rounding of a
64-term dot of unit vectors stays below 3.8e-6), the stitched map rtol
1e-4 with atol 1e-5 * max|CPU| (cuDNN against oneDNN through ResNet-101);
selftrain: MSC_TIE_GAP 1e-4 (float32 sums of 10 members' values up to
1), the walk rtol 1e-3 with atol 1e-4 * max|float64| (six float32
squarings of [n, n] products), the pyramids' float32 probabilities card
against CPU rtol 1e-5 / atol 1e-6 (KNN: exact one-hot means, resize sums
alone differ) and rtol 1e-3 / atol 1e-4 (softmax: the stitch's rtol
through the logits), their labels equal but where the CPU's top two lie
within that tolerance.
"""

from __future__ import annotations

import contextlib
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


# the positional tensor arguments of each family's stats function; the
# kappas follow them
STATS_ARGS = {
    "joint": ("emb", "pix_lab", "own_idx", "pix_tags", "protos",
              "proto_lab", "proto_tags", "proto_valid", "num_valid"),
    "set": ("emb", "pix_tags", "own_idx", "protos", "proto_tags",
            "proto_valid", "num_valid"),
    "hard": ("emb", "pix_lab", "own_idx", "protos", "proto_lab",
             "num_valid")}
PIXEL_ARGS = ("pix_lab", "own_idx", "pix_tags")


def stats_args(family, case, emb, protos, rows=slice(None)):
    """The positional tensor arguments of the family's stats function
    (pixel arrays cut to `rows`)."""
    given = {"emb": emb, "protos": protos}
    return [given[k] if k in given else
            case[k][rows] if k in PIXEL_ARGS else case[k]
            for k in STATS_ARGS[family]]


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
    on the others, or the [stats, N] tensor `cotangents` itself; dE must
    be exactly 0 on the rows without one (dE and dP both when no row
    carries one)."""
    n = case["emb"].shape[0]
    if torch.is_tensor(cotangents):
        g = cotangents
        carries = (g != 0).any(0)
    else:
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


def check_recorded(torch, fused, family, label, recorded, seed):
    """The family's kernels on the stats inputs a path recorded (its last
    call), on the cotangents its backward handed them and on randn ones,
    against the plain version at the kernel checks' tolerances."""
    names = STATS_ARGS[family]
    case = dict(zip(names, recorded["args"]))
    kappas = tuple(recorded["args"][len(names):])
    check_case(torch, fused, family, f"{label}, its own cotangents", case,
               kappas, seed, recorded["grads"])
    check_case(torch, fused, family, f"{label}, randn cotangents", case,
               kappas, seed)


@contextlib.contextmanager
def recording_stats(torch, fused, family):
    """Patches the family's stats function to keep its last call's inputs
    ("args") and the cotangent that the backward hands its kernels
    ("grads"); yields the dict they go into."""
    name = STATS_FN[family]
    orig = getattr(fused, name)
    last = {}

    def keep_cotangent(g):
        last["grads"] = g.detach().clone()

    def recording(*args):
        last["args"] = [a.detach() if torch.is_tensor(a) else a
                        for a in args]
        stats = orig(*args)
        stats.register_hook(keep_cotangent)
        return stats

    setattr(fused, name, recording)
    try:
        yield last
    finally:
        setattr(fused, name, orig)


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

    masked = []
    orig_ll = fused._ll_from_stats

    def counting(own_s, same_s, diff_s, pixel_mask, reduction="mean"):
        masked.append(pixel_mask.sum())  # pixels in the loss, read later
        return orig_ll(own_s, same_s, diff_s, pixel_mask, reduction)

    fused._ll_from_stats = counting
    metrics_log = []
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    # the last call's inputs, for the timings
    with recording_stats(torch, fused, family) as last:
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


# ---------------------------------------------------------------------------
# Inference: the single-scale KNN path at VOC's test geometry
# ---------------------------------------------------------------------------

BANK_SIZE = 1523808  # VOC train_aug: 10582 images x at most 144 clusters
COPIES = 20  # each built prototype's copies in the bank
# f64-vs-f32 near-tie gap of a 64-term dot of unit vectors: float32
# rounding stays below 64 * 2^-24 = 3.8e-6
TIE_GAP = 1e-5
# the card's float32 stitched map against the CPU's (cuDNN vs oneDNN
# through ResNet-101, TF32 off)
STITCH_RTOL, STITCH_ATOL_REL = 1e-4, 1e-5
INFERENCE = {  # bashscripts/voc12/train_spml_scribble.sh:50-52, 82-100
    "network": {"backbone_types": "panoptic_deeplab_101",
                "embedding_dim": 64, "kmeans_num_clusters": [12, 12],
                "kmeans_iterations": 10},
    "dataset": {"num_classes": 21},
    "test": {"image_size": 512, "crop_size": [512, 512],
             "stride": [512, 512]},
    "tpu": {"compute_dtype": "bfloat16"},
}


def inference_images(cfg, n, seed):
    """n normalized images with blobby labels, 512 x 384 and 384 x 512 in
    turn (VOC's shapes after the 512 resize)."""
    from spml_tpu_torch.train.flagship import blobby_batch

    batch = blobby_batch(n, 512, cfg.dataset.num_classes, seed=seed,
                         device="cpu")
    mean = np.asarray(cfg.network.pixel_means, np.float32)
    std = np.asarray(cfg.network.pixel_stds, np.float32)
    out = []
    for i in range(n):
        h, w = (512, 384) if i % 2 == 0 else (384, 512)
        img = batch["image"][i, :h, :w].numpy()
        out.append((((img - mean) / std).astype(np.float32),
                    batch["semantic_label"][i, :h, :w].numpy()))
    return out


def make_bank(torch, built, num_classes):
    """The bank: each built prototype COPIES times (row r at r + k *
    len(built)), then random unit vectors with labels 0..C-1 (seed 0) up
    to BANK_SIZE. Returns (prototypes, labels, valid, built row of each
    bank row or -1)."""
    protos, labels = built
    nb = protos.shape[0]
    rest = BANK_SIZE - COPIES * nb
    gen = torch.Generator(DEVICE).manual_seed(0)
    rand = torch.randn(rest, protos.shape[1], device=DEVICE, generator=gen)
    rand = rand / rand.norm(dim=1, keepdim=True)
    bank_p = torch.cat([protos.repeat(COPIES, 1), rand])
    bank_l = torch.cat([labels.repeat(COPIES),
                        torch.randint(0, num_classes, (rest,), device=DEVICE,
                                      generator=gen, dtype=labels.dtype)])
    owner = torch.cat([torch.arange(nb, device=DEVICE).repeat(COPIES),
                       torch.full((rest,), -1, device=DEVICE)])
    return (bank_p, bank_l, torch.ones(BANK_SIZE, dtype=torch.bool,
                                       device=DEVICE), owner)


def check_self_retrieval(torch, eng, images, builds, offsets, bank, owner):
    """(a) predictions in [0, C); (b) each image's prediction equals its
    own clusters' majority labels, but on clusters whose self-affinity in
    float64 lies within TIE_GAP of a prototype not its copy (a near-tie
    the float32 top 20 may break either way). Returns (mismatched pixels,
    near-tie clusters)."""
    c = eng.config.dataset.num_classes
    bank64 = bank[0].double()
    mismatched, near = 0, 0
    for (image, _), (protos, labels, valid, clusters), off in zip(
            images, builds, offsets):
        pred = eng.predict_semantic(image, *bank)
        if pred.min() < 0 or pred.max() >= c:
            raise AssertionError(f"inference: prediction outside [0, {c})")
        want = labels[clusters]
        bad = np.unique(clusters[pred != want])
        rows = np.cumsum(valid) - 1 + off  # built row of each valid cluster
        for k in np.flatnonzero(valid):
            p = torch.as_tensor(protos[k], device=DEVICE).double()
            aff = bank64 @ p
            own = owner == int(rows[k])
            tie = float(aff[~own].max()) >= float(aff[own].min()) - TIE_GAP
            near += tie
            if k in bad and not tie:
                raise AssertionError(
                    f"inference: cluster {k} predicted "
                    f"{np.unique(pred[clusters == k])}, its majority label "
                    f"is {labels[k]}, and no prototype ties its own")
        mismatched += int((pred != want).sum())
    return mismatched, near


def check_topk(torch, eng, image, bank):
    """(c) one image not in the bank: each valid segment's top-20 labels
    against a float64 recomputation of its affinities on the card, equal
    as multisets but where the 20th and 21st float64 affinities lie within
    TIE_GAP; and the stages composed equal predict_semantic. Returns
    (segments checked, segments excused)."""
    h, w = image.shape[:2]
    img = eng.upload_image(image)
    seg_ids, protos, seg_valid = eng.segment(eng.stitch(img), (h, w))
    topk = eng.retrieve(protos, seg_valid, bank)
    staged = eng.vote(topk, seg_ids, tuple(img.shape[:2]))[:h, :w]
    if not np.array_equal(staged.cpu().numpy(),
                          eng.predict_semantic(image, *bank)):
        raise AssertionError("inference: the stages differ from "
                             "predict_semantic")
    aff = protos.double() @ bank[0].double().T
    vals, idx = torch.sort(aff, dim=1, descending=True, stable=True)
    want = bank[1][idx[:, :20]]
    checked = excused = 0
    for k in torch.nonzero(seg_valid).flatten().tolist():
        checked += 1
        if torch.equal(torch.sort(topk[k])[0], torch.sort(want[k])[0]):
            continue
        if float(vals[k, 19] - vals[k, 20]) >= TIE_GAP:
            raise AssertionError(f"inference: segment {k} top-20 labels "
                                 f"{topk[k].tolist()}, float64 "
                                 f"{want[k].tolist()}")
        excused += 1
    return checked, excused


def check_card_against_cpu(torch):
    """The device path against the CPU path, float32, crop 128, stride 64,
    a 192 x 160 image (2 x 2 windows): stitched map within STITCH_RTOL,
    cluster maps, prototype labels and predictions equal. Returns the
    stitched map's largest absolute error."""
    import copy

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.inference import engine
    from spml_tpu_torch.models.embeddings import build_embedding_model

    over = dict(INFERENCE, test={"image_size": 0, "crop_size": [128, 128],
                                 "stride": [64, 64]},
                tpu={"compute_dtype": "float32"})
    cfg = load_config(overrides=over)
    model = build_embedding_model("panoptic_deeplab_101", 64)
    engines = {dev: engine.InferenceEngine(cfg, copy.deepcopy(model), dev)
               for dev in ("cpu", DEVICE)}
    image, label = inference_images(cfg, 1, seed=2)[0]
    image, label = image[:192, :160], label[:192, :160]
    if engines["cpu"].windows(*engines["cpu"].bucket_shape(192, 160)) != [
            (0, 0), (0, 64), (64, 0), (64, 64)]:
        raise AssertionError("inference: the CPU check is not 2 x 2 windows")
    rng = np.random.RandomState(1)
    bank_p = rng.randn(2000, 64).astype(np.float32)
    bank_p /= np.linalg.norm(bank_p, axis=1, keepdims=True)
    bank = (bank_p, rng.randint(0, 21, 2000), np.ones(2000, bool))
    out = {dev: (eng.stitched_embeddings(image).cpu(),
                 eng.build_prototypes(image, label, return_clusters=True),
                 eng.predict_semantic(image, *bank))
           for dev, eng in engines.items()}
    (want, wbuild, wpred), (got, gbuild, gpred) = out["cpu"], out[DEVICE]
    atol = STITCH_ATOL_REL * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=STITCH_RTOL, atol=atol,
                               msg=lambda m: f"inference stitch: {m}")
    for name, g, w in (("clusters", gbuild[3], wbuild[3]),
                       ("labels", gbuild[1], wbuild[1]),
                       ("valid", gbuild[2], wbuild[2]),
                       ("prediction", gpred, wpred)):
        if not np.array_equal(g, w):
            raise AssertionError(f"inference: card and CPU {name} differ in "
                                 f"{int((g != w).sum())} places")
    return float((got - want).abs().max())


def time_inference(torch, eng, images, bank):
    """CUDA events around 10 images after 3 warm-up images: (build ms,
    predict ms, host ms of predict, {stage: ms}, peak bytes of predict)."""
    order = [images[i % len(images)] for i in range(13)]

    def timed(fn):
        for image, label in order[:3]:
            fn(image, label)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for image, label in order[3:]:
            fn(image, label)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 10, (time.perf_counter() - t0) * 100

    build_ms, _ = timed(lambda im, lab: eng.build_prototypes(im, lab))
    torch.cuda.reset_peak_memory_stats()
    predict_ms, host_ms = timed(lambda im, lab: eng.predict_semantic(
        im, *bank))
    peak = torch.cuda.max_memory_allocated()

    stages = ("upload", "forward", "stitch", "kmeans", "knn", "vote")
    totals = dict.fromkeys(stages, 0.0)
    for n, (image, _) in enumerate(order):
        h, w = image.shape[:2]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        img = eng.upload_image(image)
        ev[1].record()
        emb = eng.embed_windows(img)
        ev[2].record()
        emb_map = eng.overlap_average(emb, *img.shape[:2])
        ev[3].record()
        seg_ids, protos, seg_valid = eng.segment(emb_map, (h, w))
        ev[4].record()
        topk = eng.retrieve(protos, seg_valid, bank)
        ev[5].record()
        eng.vote(topk, seg_ids, tuple(img.shape[:2]))[:h, :w].cpu()
        ev[6].record()
        torch.cuda.synchronize()
        if n >= 3:
            for i, st in enumerate(stages):
                totals[st] += ev[i].elapsed_time(ev[i + 1]) / 10
    return build_ms, predict_ms, host_ms, totals, peak


def run_inference(torch):
    """The single-scale KNN path at VOC's test geometry: the flagship
    network from random weights of seed 0 (eval mode, bf16 convs), 12 x 12
    k-means x 10, 21 classes, top 20, crop = stride = 512; memory bank
    entries from 8 images, a bank of BANK_SIZE, prediction of the same 8,
    the checks and the timings."""
    import tempfile

    from spml_tpu_torch import cli
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.inference import engine

    t0 = time.perf_counter()
    cfg = load_config(overrides=INFERENCE)
    with tempfile.TemporaryDirectory() as snapshot:  # none: seed 0 weights
        eng = engine.InferenceEngine(
            cfg, cli.build_eval_models(cfg, snapshot, DEVICE), DEVICE)
    images = inference_images(cfg, 8, seed=0)
    builds, offsets, parts = [], [], ([], [])
    for image, label in images:
        protos, labels, valid, clusters = eng.build_prototypes(
            image, label, return_clusters=True)
        builds.append((protos, labels, valid, clusters))
        offsets.append(sum(len(p) for p in parts[0]))
        parts[0].append(protos[valid])
        parts[1].append(labels[valid])
    built = (torch.as_tensor(np.concatenate(parts[0]), device=DEVICE),
             torch.as_tensor(np.concatenate(parts[1]), device=DEVICE))
    *bank, owner = make_bank(torch, built, cfg.dataset.num_classes)
    log("inference", f"model and 8 memory-bank entries in "
        f"{time.perf_counter() - t0:.1f} s: {built[0].shape[0]} valid "
        f"prototypes of {8 * 144}, bank {bank[0].shape[0]} x "
        f"{bank[0].shape[1]} float32 ({COPIES} copies each, the rest random "
        "unit vectors)")
    mismatched, near = check_self_retrieval(torch, eng, images, builds,
                                            offsets, bank, owner)
    fresh = inference_images(cfg, 1, seed=1)[0][0]
    checked, excused = check_topk(torch, eng, fresh, bank)
    stitch_err = check_card_against_cpu(torch)
    log("inference", f"checks ok: (a) predictions in [0, 21); (b) "
        f"self-retrieval {mismatched} pixels off their clusters' majority "
        f"labels, {near} near-tie clusters (gap {TIE_GAP}); (c) top-20 "
        f"labels of {checked} segments equal float64's, {excused} excused "
        f"as near-ties; card vs CPU float32 (crop 128, stride 64, 192 x "
        f"160, 2 x 2 windows) stitched max_abs_err {stitch_err:.3e} "
        f"(rtol {STITCH_RTOL}), clusters, labels and predictions equal")
    build_ms, predict_ms, host_ms, stages, peak = time_inference(
        torch, eng, images, bank)
    log("inference", f"VOC test geometry (panoptic_deeplab_101 bf16, 512 x "
        f"384 / 384 x 512 in a 512 x 512 bucket, 12 x 12 k-means x 10, top "
        f"20 of {BANK_SIZE}): build_prototypes {build_ms:.2f} ms/image; "
        f"predict_semantic {predict_ms:.2f} ms/image (host clock "
        f"{host_ms:.2f}), {1000 / predict_ms:.2f} images/s; split "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f" ms; peak memory {peak / 2**30:.2f} GiB; card "
        f"{nvidia_smi_line()}")


# ---------------------------------------------------------------------------
# Driver: the train entry points from an image list on disk
# ---------------------------------------------------------------------------

WORLD_IMAGES = 24
PREFETCH = 4  # the driver's Loader default: batches made ahead
# stage 2 and the baseline: enough steps that the last ones come after
# the batches prefetched during the first step (the warm-up) are used up
DRAINED_STEPS = 12
STAGE1 = {  # bashscripts/voc12/train_spml_scribble.sh:17-46 rendered into
    # configs/voc12_template.yaml, cut to 4 + 2 iterations
    "network": {"backbone_types": "panoptic_deeplab_101",
                "embedding_dim": 64, "kmeans_num_clusters": [6, 6],
                "kmeans_iterations": 10, "label_divisor": 2048,
                "prediction_types": "segsort", "bn_momentum": 3e-4},
    "dataset": {"num_classes": 21, "semantic_ignore_index": 255},
    "train": {"lr_policy": "poly", "snapshot_step": 2,
              "tensorboard_step": 100, "max_iteration": 4,
              "warmup_iteration": 100, "base_lr": 3e-3,
              "weight_decay": 5e-4, "momentum": 0.9, "batch_size": 4,
              "crop_size": [512, 512], "memory_bank_size": 2,
              "random_mirror": True, "random_scale": True,
              "random_crop": True, "shuffle": True,
              "sem_ann_concentration": 6.0, "sem_occ_concentration": 12.0,
              "img_sim_concentration": 16.0, "sem_ann_loss_weight": 1.0,
              "sem_occ_loss_weight": 0.5, "img_sim_loss_weight": 0.1},
    "test": {"image_size": 512, "crop_size": [512, 512],
             "stride": [512, 512]},
    # the fused joint loss as bench.py and train/flagship.py set it: the
    # shipped template leaves it off (the dense losses, no kernel)
    "tpu": {"segment_capacity": 256, "compute_dtype": "bfloat16",
            "use_fused_loss": True},
    "num_threads": 4,
}


def driver_configs(stage1_dir):
    """(stage 1, stage 2, the Adam baseline) configs. Stage 2 is the
    rendered classifier config (train_spml_scribble.sh:123-129:
    PRETRAINED = the stage-1 snapshot, softmax_classifier, batch 16, 1 x 1
    clusters, no k-means iteration), cut to DRAINED_STEPS iterations; the
    baseline is stage 1 with softmax_classifier and Adam, as many."""
    from spml_tpu_torch.config import load_config

    stage1 = load_config(overrides=STAGE1)
    stage2 = load_config(overrides=STAGE1)
    stage2.network.pretrained = stage1_dir
    stage2.network.prediction_types = "softmax_classifier"
    stage2.network.kmeans_iterations = 0
    stage2.network.kmeans_num_clusters = (1, 1)
    stage2.train.batch_size = 16
    stage2.train.max_iteration = DRAINED_STEPS
    base = load_config(overrides=STAGE1)
    base.network.prediction_types = "softmax_classifier"
    base.train.optimizer = "adam"
    base.train.max_iteration = DRAINED_STEPS
    return stage1, stage2, base


class DriverProbe:
    """Times one driver call from the outside: the loader's next() (the
    wait of each step), and each step call between CUDA events on the
    host clock, followed by a synchronize (so the host time is the
    step's own; the driver itself synchronizes only to log). Keeps every
    step's metrics, the first step's state and the frozen embedding a
    classifier step is built over."""

    def __init__(self, torch):
        self.torch = torch
        self.waits, self.steps, self.metrics = [], [], []
        self.first_step, self.first_params, self.frozen = None, None, None
        self.recorded, self.held = None, 0  # set by the caller

    def __enter__(self):
        from unittest import mock

        from spml_tpu_torch.data import datasets
        from spml_tpu_torch.train import classifier_step, step

        loader_iter = datasets.Loader.__iter__
        probe = self

        def timed_iter(loader):
            it = loader_iter(loader)
            try:
                while True:
                    t0 = time.perf_counter()
                    batch = next(it)
                    probe.waits.append(time.perf_counter() - t0)
                    yield batch
            finally:
                it.close()

        self.patches = [
            mock.patch.object(datasets.Loader, "__iter__", timed_iter),
            mock.patch.object(step, "make_train_step",
                              self.timed(step.make_train_step)),
            mock.patch.object(
                classifier_step, "make_classifier_train_step",
                self.timed(classifier_step.make_classifier_train_step))]
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()
        self.patches = None  # its closures hold the probe: no cycle left

    def timed(self, make):
        torch = self.torch

        def make_timed(config, *rest):
            if rest:
                self.frozen = rest[0]
            train_step = make(config, *rest)
            self.raw_step = train_step

            def step(state, batch):
                self.last_batch = batch
                if self.first_step is None:
                    self.first_step = state.step
                    model = (state.emb_model if state.emb_model is not None
                             else state.cls_model)
                    self.first_params = {
                        n: p.detach().clone()
                        for n, p in model.named_parameters()}
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                state, metrics = train_step(state, batch)
                end.record()
                torch.cuda.synchronize()
                self.steps.append((time.perf_counter() - t0, start, end))
                self.metrics.append({k: float(v) for k, v in metrics.items()})
                return state, metrics
            return step
        return make_timed

    def replay(self, state, n=5):
        """After the driver call (its loader closed): one warm-up and n
        steps of the same step function on the run's last batch, first
        each between CUDA events and a synchronize as the driver's steps
        are timed, then n back to back between two events, as the
        recipes' steps are; (host ms, device ms, back-to-back ms) per
        step."""
        torch = self.torch
        state, _ = self.raw_step(state, self.last_batch)
        torch.cuda.synchronize()
        host, dev = [], []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, _ = self.raw_step(state, self.last_batch)
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1000)
            dev.append(start.elapsed_time(end))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            state, _ = self.raw_step(state, self.last_batch)
        end.record()
        torch.cuda.synchronize()
        self.replayed = (float(np.mean(host)), float(np.mean(dev)),
                         start.elapsed_time(end) / n)

    def check_finite(self, what):
        bad = [m for m in self.metrics
               if not all(math.isfinite(v) for k, v in m.items()
                          if k.endswith("loss"))]
        if bad or not self.metrics:
            raise AssertionError(f"{what}: non-finite loss: {bad}")

    def steady(self, first):
        """(host ms in the step call, loader wait ms, device ms) a step,
        means over the steps from index `first` on."""
        n = len(self.steps)
        return (float(np.mean([h * 1000 for h, _, _ in self.steps[first:]])),
                float(np.mean([w * 1000 for w in self.waits[first:n]])),
                float(np.mean([s.elapsed_time(e)
                               for _, s, e in self.steps[first:]])))

    def line(self, what, batch, state):
        """The [driver] line: steady state over the steps after the first,
        and over those after the start-up prefetch drained (the steps
        after the first PREFETCH + 1, whose batches the loader made while
        steps ran); then the replay (which moves `state` on: call it after
        the checks)."""
        self.replay(state)
        n = len(self.steps)
        host, wait, dev = self.steady(1)
        drained = "none: too few steps"
        if n > PREFETCH + 1:
            d_host, d_wait, _ = self.steady(PREFETCH + 1)
            drained = (
                f"loader wait {d_wait:.2f} ms/step, data-wait share "
                f"{d_wait / (d_wait + d_host):.1%}, host {d_host:.2f} ms/step"
                f" in the step call, {batch * 1000 / (d_wait + d_host):.2f} "
                "images/s")
        log("driver", f"{what}: {n} steps; steady state (steps 2-{n}): "
            f"host {host:.2f} ms/step in the step call, loader wait "
            f"{wait:.2f} ms/step, device {dev:.2f} ms/step (CUDA events), "
            f"{batch * 1000 / (host + wait):.2f} images/s (batch {batch} "
            f"over wait + step); after the start-up prefetch of {PREFETCH} "
            f"batches drained (steps {PREFETCH + 2}-{n}): {drained}; waits "
            f"{[round(w * 1000, 1) for w in self.waits[:n]]} ms; first step "
            f"{self.steps[0][0] * 1000:.0f} ms; the same step on the last "
            f"batch with the loader closed: host {self.replayed[0]:.2f} ms, "
            f"device {self.replayed[1]:.2f} ms a step, "
            f"{self.replayed[2]:.2f} ms back to back; peak memory "
            f"{self.torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({self.held / 2**30:.2f} GiB held when the run began); "
            f"card {nvidia_smi_line()}")


def run_driver(torch, fused, dc):
    """Stage 1 (train_spml, ListTagDataset, K1-K3 on every step) for 4
    iterations and resumed to 6, the single-scale KNN chain on its
    snapshot, stage 2 (train_classifier over it), and the baseline
    (softmax_classifier with Adam), on a world of WORLD_IMAGES images
    written from seed 0 into a temporary directory; then the
    self-training phase on that world and those snapshots; the checks of
    the module docstring."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="spml_driver_") as root:
        world = drive_all(torch, fused, root)
        run_selftrain(torch, fused, dc, world)


def drive_all(torch, fused, root):
    import argparse

    from spml_tpu_torch.data import datasets, synthetic
    from spml_tpu_torch.inference import runner
    from spml_tpu_torch.train import driver, optim
    from spml_tpu_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    data = os.path.join(root, "world")
    lst = synthetic.write_world(data, WORLD_IMAGES, seed=0)
    log("driver", f"world of {WORLD_IMAGES} JPEGs (500 x 375 / 375 x 500, 21 "
        f"classes, ~30 segments each) in {time.perf_counter() - t0:.1f} s")
    stage1_dir = os.path.join(root, "stage1")
    stage1, stage2, base = driver_configs(stage1_dir)

    def args(snapshot, data_list=lst, save=None, memory=None):
        return argparse.Namespace(data_dir=data, data_list=data_list,
                                  snapshot_dir=snapshot, save_dir=save,
                                  semantic_memory_dir=memory)

    def drive(what, fn, cfg, *a):
        torch.cuda.reset_peak_memory_stats()
        fused.reset_launch_counts()
        held = torch.cuda.memory_allocated()
        with DriverProbe(torch) as probe, \
                recording_stats(torch, fused, "joint") as recorded:
            state = fn(args(*a), cfg, device=DEVICE)
        launches = {k: v for k, v in fused.LAUNCHES.items() if v}
        probe.check_finite(what)
        probe.recorded, probe.held = recorded, held
        return state, probe, launches

    # ---- stage 1: 4 iterations, then resumed to 6 ----
    ck_dir = os.path.join(stage1_dir, "checkpoints")
    for first, last in ((0, 4), (4, 6)):
        stage1.train.max_iteration = last
        stage1.train.resume = first > 0
        state = probe = None  # the last run's, out of this run's peak
        state, probe, launches = drive(f"stage 1 {first}-{last}",
                                       driver.train_spml, stage1,
                                       stage1_dir)
        n = last - first
        want = {"joint_stats": n, "joint_grad_emb": n,
                "joint_grad_proto": n}
        if launches != want:
            raise AssertionError(f"stage 1: launches {launches}, want "
                                 f"{want} (K1-K3 once a step, no other)")
        lr = optim.make_schedule(stage1.train)(first)
        if (probe.first_step != first or state.step != last
                or probe.metrics[0]["learning_rate"] != lr):
            raise AssertionError(
                f"stage 1 {first}-{last}: first step {probe.first_step} "
                f"(lr {probe.metrics[0]['learning_rate']}, want {lr}), "
                f"last {state.step}")
        losses = ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            probe.metrics[-1].items()) if k.endswith("loss"))
        log("driver", f"stage 1 {first}-{last}: started at step "
            f"{probe.first_step} at lr {lr:.3e} (the schedule's), "
            f"launches {launches}; last step {losses}, "
            f"{int(probe.metrics[-1]['num_segments'])} segments")
        probe.line(f"stage 1 {first}-{last} (panoptic_deeplab_101 bf16, "
                   "ListTagDataset, crop 512)", stage1.train.batch_size,
                   state)
    if ckpt.steps(ck_dir) != [2, 4, 6]:
        raise AssertionError(f"stage 1 checkpoints {ckpt.steps(ck_dir)}")
    # K1-K3 at the driver's own shapes: the last step's stats inputs
    check_recorded(torch, fused, "joint", "stage 1 step 6", probe.recorded,
                   seed=40)
    state = probe = None

    # ---- the single-scale KNN chain on the stage-1 snapshot ----
    infer = load_infer_config(stage1)
    with open(lst) as f:
        items = f.read().splitlines()
    lists = {}
    for name, n in (("memory", 8), ("test", 4)):
        lists[name] = os.path.join(root, f"{name}.txt")
        with open(lists[name], "w") as f:
            f.write("\n".join(items[:n]) + "\n")
    train_out = os.path.join(root, "results", "train")
    val_out = os.path.join(root, "results", "val")
    t0 = time.perf_counter()
    runner.run_prototype(args(stage1_dir, lists["memory"], train_out),
                         infer, device=DEVICE)
    runner.run_knn_inference(
        args(stage1_dir, lists["test"], val_out,
             os.path.join(train_out, "semantic_prototype")),
        infer, device=DEVICE)
    result = runner.run_benchmark(args(stage1_dir, lists["test"], val_out),
                                  infer)
    pngs = sorted(os.listdir(os.path.join(val_out, "semantic_gray")))
    miou = result["mean_iou"]
    if not (math.isfinite(miou) and 0.0 <= miou <= 1.0) or len(pngs) != 4:
        raise AssertionError(f"inference chain: mIoU {miou}, PNGs {pngs}")
    log("driver", f"KNN chain on the stage-1 snapshot (step 6): "
        f"run_prototype over 8 images, run_knn_inference over 4, "
        f"run_benchmark mIoU {miou:.4f}, {len(pngs)} PNGs, "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- stage 2 over the stage-1 snapshot ----
    saved = ckpt.read(ck_dir)["emb_model"]  # host memory
    state, probe, launches = drive("stage 2", driver.train_classifier,
                                   stage2, os.path.join(root, "stage2"))
    frozen = {k: v.cpu() for k, v in probe.frozen.state_dict().items()}
    changed = [n for n, p in state.cls_model.named_parameters()
               if not torch.equal(p, probe.first_params[n])]
    if (launches or frozen.keys() != saved.keys()
            or not all(torch.equal(frozen[k], saved[k]) for k in saved)
            or len(changed) != len(probe.first_params)):
        raise AssertionError(
            f"stage 2: launches {launches}, embedding equal to stage 1's: "
            f"{all(torch.equal(frozen[k], saved[k]) for k in saved)}, "
            f"head parameters changed {changed}")
    log("driver", f"stage 2: the embedding's {len(saved)} parameters and "
        f"BN buffers equal to stage 1's step 6, all "
        f"{len(changed)} head parameters changed, no kernel launched; last "
        f"step loss {probe.metrics[-1]['loss']:.4f}, accuracy "
        f"{probe.metrics[-1]['accuracy']:.4f}")
    rates = [loader_ms(cfg, cls, args(root)) for cfg, cls in (
        (stage1, datasets.ListTagDataset),
        (stage2, datasets.ListTagClassifierDataset))]
    log("driver", "the loaders alone, 8 batches each drawn back to back "
        "from a fresh Loader (4 threads, 4 batches prefetched, no step "
        f"running): stage 1 (ListTagDataset, batch 4) {rates[0]:.1f} ms a "
        "batch; stage 2 (ListTagClassifierDataset, batch 16) "
        f"{rates[1]:.1f} ms a batch")
    probe.line("stage 2 (ListTagClassifierDataset, frozen "
               "panoptic_deeplab_101, crop 512)", stage2.train.batch_size,
               state)

    # ---- the fully supervised baseline with Adam ----
    state = probe = None
    state, probe, launches = drive("baseline", driver.train_spml, base,
                                   os.path.join(root, "baseline"))
    moved = {n: not torch.equal(p, probe.first_params[n])
             for n, p in state.emb_model.named_parameters()}
    frozen_moved = [n for n, m in moved.items()
                    if m and n.split(".")[1] in ("conv1", "res2")]
    trained_still = [n for n, m in moved.items() if not m
                     and n.split(".")[1] in ("res3", "res4", "res5")]
    if (launches or state.memory.valid.any() or frozen_moved
            or trained_still or state.adam_count != DRAINED_STEPS):
        raise AssertionError(
            f"baseline: launches {launches}, bank entries "
            f"{int(state.memory.valid.sum())}, stem/res2 moved "
            f"{frozen_moved}, res3-5 unmoved {trained_still}, Adam count "
            f"{state.adam_count}")
    log("driver", f"baseline (softmax_classifier, Adam): no kernel "
        f"launched, bank empty, stem and res2 unchanged, every res3-5 "
        f"parameter moved, Adam count {state.adam_count}; last step "
        f"sem_ann_loss {probe.metrics[-1]['sem_ann_loss']:.4f}")
    probe.line("baseline (panoptic_deeplab_101 bf16, ListTagDataset, crop "
               "512, Adam)", base.train.batch_size, state)
    return argparse.Namespace(root=root, data=data, list=lst,
                              lists=lists, stage1_dir=stage1_dir,
                              stage1=stage1, stage2=stage2,
                              stage2_dir=os.path.join(root, "stage2"),
                              bank=os.path.join(train_out,
                                                "semantic_prototype"))


# ---------------------------------------------------------------------------
# Self-training: MSC, CRF, softmax and the pseudo-labels on the world and
# snapshots of the driver phase
# ---------------------------------------------------------------------------

MSC_SCALES = (0.5, 0.75, 1, 1.25, 1.5)  # inference_msc.py
# cli.parse_args's --crf_* defaults: the recipe passes none
# (train_spml_scribble.sh:140, 168, CRF_FLAGS unset)
CRF_FLAGS = dict(crf_iter_max=10, crf_pos_xy_std=1, crf_pos_w=3,
                 crf_bi_xy_std=67, crf_bi_w=4, crf_bi_rgb_std=3)
# float32 label path against float64: a sum of 10 members' values up to 1
# through two bilinear resizes, a few tens of roundings of 2^-24 * 10
MSC_TIE_GAP = 1e-4
# the walk (T ** 64 by six float32 squarings of [n, n] products) against
# float64, and the pyramids' float32 probabilities card against CPU: the
# KNN one's are sums of exact one-hot means (resize sums alone differ),
# the softmax one's carry the conv stack's STITCH_RTOL through the logits
WALK_RTOL, WALK_ATOL_REL = 1e-3, 1e-4
KNN_PROB_RTOL, KNN_PROB_ATOL = 1e-5, 1e-6
# a member pixel may join another cluster on the card only where the
# CPU's last k-means E-step, in float64, puts its two best clusters this
# close: the card's stitched map is within STITCH_RTOL 1e-4 of the CPU's,
# so each unit-vector affinity moves by ~2e-4 at most
KMEANS_TIE_GAP = 1e-3
SOFTMAX_PROB_RTOL, SOFTMAX_PROB_ATOL = 1e-3, 1e-4
DENSEPOSE_POINTS = 300  # labelled pixels an image, the rest 255
PSEUDO_STAGES = ("forward", "affinity", "walk", "pseudo_crf")


def quiet(torch, fn, *a, **k):
    """fn(*a, **k) with its per-image lines kept from the log; (seconds
    to the card's last result, lines printed)."""
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        fn(*a, **k)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out.getvalue().count("\n")


def read_pngs(save_dir, n, num_classes, what):
    """The n gray PNGs of a run, {name: labels}; each label in [0, C) or
    the ignore label."""
    import PIL.Image

    gray = os.path.join(save_dir, "semantic_gray")
    names = sorted(os.listdir(gray))
    colour = sorted(os.listdir(os.path.join(save_dir, "semantic_color")))
    if len(names) != n or colour != names:
        raise AssertionError(f"{what}: {len(names)} gray and {len(colour)} "
                             f"colour PNGs, want {n}")
    out = {}
    for name in names:
        lab = np.array(PIL.Image.open(os.path.join(gray, name)))
        bad = (lab >= num_classes) & (lab != 255)
        if bad.any():
            raise AssertionError(f"{what}: {name} holds labels "
                                 f"{np.unique(lab[bad])}")
        out[name] = lab
    return out


def check_msc_labels(torch, recorded, pngs):
    """(a) the MSC labels of the runner against the float64 argmax of the
    very sums it resized (recorded): equal but where the float64 top two
    lie within MSC_TIE_GAP. Returns (pixels, near-tie pixels)."""
    from spml_tpu_torch.inference import msc

    pixels = near = 0
    for (acc, final_hw), (name, lab) in zip(recorded, sorted(pngs.items())):
        h, w = acc.shape[:2]
        wr = msc.bilinear_resize_weights(final_hw[0], h, final_hw[0], h,
                                         False, acc.device).double()
        wc = msc.bilinear_resize_weights(final_hw[1], w, final_hw[1], w,
                                         False, acc.device).double()
        res = torch.einsum("pw,owc->opc", wc,
                           torch.einsum("oi,iwc->owc", wr, acc.double()))
        top2 = torch.topk(res, 2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()
        want = res.argmax(-1).cpu().numpy()
        off = lab != want
        if (gap[off] >= MSC_TIE_GAP).any():
            raise AssertionError(
                f"selftrain (a): {name}: {int(off.sum())} labels off the "
                f"float64 argmax, largest gap {gap[off].max():.3e}")
        pixels += lab.size
        near += int(off.sum())
    return pixels, near


def near_tie_mismatch(got, want, probs, rtol, atol, what, skip=None):
    """Labels of the card against the CPU's: equal but where the CPU's
    top two probabilities lie within the probabilities' tolerance, and
    outside `skip`. Returns the excused pixels."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    tol = atol + rtol * top2[..., 1]
    off = got != want
    if skip is not None:
        off &= ~skip
    if (top2[..., 1] - top2[..., 0] >= tol)[off].any():
        raise AssertionError(f"selftrain (e): card and CPU {what} labels "
                             f"differ in {int(off.sum())} places")
    return int(off.sum())


def kmeans_gap64(torch, eng, emb_map, hw, pixels):
    """The float64 gap between a member's two best clusters at `pixels`
    in the last E-step of engine.segment's k-means on emb_map: the first
    iterations in float32 as segment runs them, the last M-step and
    E-step in float64."""
    from spml_tpu_torch.ops import common, kmeans

    net = eng.config.network
    hb, wb, d = emb_map.shape
    k = net.kmeans_num_clusters[0] * net.kmeans_num_clusters[1]
    rows = torch.arange(hb)[:, None] < hw[0]
    cols = torch.arange(wb)[None, :] < hw[1]
    valid = (rows & cols).reshape(-1)
    loc = common.generate_location_features(hb, wb) - 0.5
    emb_loc = common.normalize_embedding(torch.cat(
        [common.normalize_embedding(emb_map.reshape(-1, d)),
         loc.reshape(-1, 2)], dim=-1))
    grid = kmeans.initialize_cluster_labels(
        tuple(net.kmeans_num_clusters), (hb, wb)).reshape(-1)
    labels = kmeans.kmeans_with_initial_labels(
        emb_loc[None], grid[None], k, net.kmeans_iterations - 1,
        valid[None].float())[0]
    protos = kmeans.calculate_prototypes_from_labels(
        emb_loc.double(), labels, k, valid.double())
    top2 = torch.topk(emb_loc.double()[pixels] @ protos.T, 2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


def knn_cluster_footprint(torch, engines, image, scales):
    """Each pyramid member on the card against the CPU: the stitched maps
    within STITCH_RTOL, the cluster maps equal but at float64 near-ties
    of the last E-step (gap below KMEANS_TIE_GAP). Returns (the base
    pixels those near-tie pixels feed through the resize, [h, w] bool;
    the near-tie pixels)."""
    from spml_tpu_torch.inference import msc

    h, w = image.shape[:2]
    footprint = torch.zeros(h, w, dtype=torch.bool)
    near = 0
    for scale in scales:
        member_hw = (int(h * scale), int(w * scale))
        out = {}
        for dev, eng in engines.items():
            members = eng.members(eng.upload_image(image), (h, w), member_hw,
                                  (False, True))
            emb = eng.stitch(members)
            out[dev] = (emb.cpu(), [eng.segment(e, member_hw)[0].cpu()
                                    for e in emb])
        (emb, want), (emb_card, got) = out["cpu"], out[DEVICE]
        torch.testing.assert_close(
            emb_card, emb, rtol=STITCH_RTOL,
            atol=STITCH_ATOL_REL * float(emb.abs().max()),
            msg=lambda m: f"selftrain (e) member {member_hw} stitch: {m}")
        hb, wb = emb.shape[1:3]
        inside = torch.zeros(hb, wb, dtype=torch.bool)
        inside[:member_hw[0], :member_hw[1]] = True
        for i, flip in enumerate((False, True)):
            off = (got[i] != want[i]) & inside.reshape(-1)
            if not off.any():
                continue
            gap = kmeans_gap64(torch, engines["cpu"], emb[i], member_hw,
                               off)
            if (gap >= KMEANS_TIE_GAP).any():
                raise AssertionError(
                    f"selftrain (e): member {member_hw} flip {flip}: "
                    f"{int(off.sum())} pixels in other clusters on the "
                    f"card, float64 gap up to {float(gap.max()):.3e}")
            near += int(off.sum())
            fed = msc.bilinear_resize(off.reshape(hb, wb, 1).float(),
                                      member_hw, (h, w), flip=flip)
            footprint |= fed[..., 0] > 0
    return footprint.numpy(), near


def check_pyramids_card_against_cpu(torch):
    """(e) the KNN and softmax device pyramids, float32, crop 128, stride
    64, a 192 x 160 image, scales (0.75, 1) with flips, card against CPU:
    the softmax probabilities within their tolerance and the labels equal
    but at near-ties; the KNN members' clusters equal but at k-means
    near-ties, and outside the base pixels those feed, the probabilities
    within their tolerance and the labels equal but at near-ties.
    Returns {engine: (max abs error outside near-ties, excused labels,
    k-means near-tie pixels)}."""
    import copy

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.inference import engine, msc
    from spml_tpu_torch.inference.softmax import SoftmaxInferenceEngine
    from spml_tpu_torch.models.embeddings import (build_classifier_head,
                                                  build_embedding_model)

    over = dict(INFERENCE, test={"image_size": 0, "crop_size": [128, 128],
                                 "stride": [64, 64]},
                tpu={"compute_dtype": "float32"})
    cfg = load_config(overrides=over)
    net, c = cfg.network, cfg.dataset.num_classes
    model = build_embedding_model(net.backbone_types, net.embedding_dim)
    head = build_classifier_head(c, net.embedding_dim)
    image = inference_images(cfg, 1, seed=2)[0][0][:192, :160]
    scales = (0.75, 1.0)
    rng = np.random.RandomState(1)
    bank_p = rng.randn(2000, net.embedding_dim).astype(np.float32)
    bank_p /= np.linalg.norm(bank_p, axis=1, keepdims=True)
    bank = (bank_p, rng.randint(0, c, 2000), np.ones(2000, bool))
    out = {}
    for kind, rtol, atol in (("knn", KNN_PROB_RTOL, KNN_PROB_ATOL),
                             ("softmax", SOFTMAX_PROB_RTOL,
                              SOFTMAX_PROB_ATOL)):
        engines, args = {}, {}
        for dev in ("cpu", DEVICE):
            if kind == "knn":
                engines[dev] = engine.InferenceEngine(
                    cfg, copy.deepcopy(model), dev)
                args[dev] = engines[dev].memory(*bank)
            else:
                engines[dev] = SoftmaxInferenceEngine(
                    cfg, copy.deepcopy(model), copy.deepcopy(head), dev)
                args[dev] = ()
        skip, near = np.zeros(image.shape[:2], bool), 0
        if kind == "knn":
            skip, near = knn_cluster_footprint(torch, engines, image, scales)
        res = {dev: (msc.msc_predict_probs_device(
            eng, image, args[dev], scales, transfer_dtype=np.float32),
            msc.msc_predict_labels_device(eng, image, args[dev], scales))
            for dev, eng in engines.items()}
        (want, wlab), (got, glab) = res["cpu"], res[DEVICE]
        torch.testing.assert_close(
            torch.from_numpy(got[~skip]), torch.from_numpy(want[~skip]),
            rtol=rtol, atol=atol,
            msg=lambda m, kind=kind: f"selftrain (e) {kind}: {m}")
        out[kind] = (float(np.abs(got - want)[~skip].max()),
                     near_tie_mismatch(glab, wlab, want, rtol, atol, kind,
                                       skip), near)
    return out


def check_walk_float64(torch, config, emb_model, image, scores):
    """(e) the walk on the card against float64 on the card, at the grid
    of a 500 x 375 image (n = 62 * 46). Returns (n, max abs error,
    float64 ms, float32 ms)."""
    from spml_tpu_torch.inference import runner
    from spml_tpu_torch.ops import randomwalk

    h, w = image.shape[:2]
    aff = runner._stride8_affinity(config, emb_model, image)
    c = scores.shape[0]
    s8 = torch.nn.functional.interpolate(
        torch.from_numpy(scores)[None].to(aff.device), size=(h // 8, w // 8),
        mode="bilinear", align_corners=False)[0].reshape(c, -1)
    randomwalk.random_walk_from_affinity(aff, s8)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = randomwalk.random_walk_from_affinity(aff, s8)
    torch.cuda.synchronize()
    f32_ms = (time.perf_counter() - t0) * 1000
    t0 = time.perf_counter()
    trans = aff.double() ** 20
    trans = trans / trans.sum(0, keepdim=True)
    for _ in range(6):
        trans = trans @ trans
    want = s8.double() @ trans
    torch.cuda.synchronize()
    f64_ms = (time.perf_counter() - t0) * 1000
    torch.testing.assert_close(
        got.double(), want, rtol=WALK_RTOL,
        atol=WALK_ATOL_REL * float(want.abs().max()),
        msg=lambda m: f"selftrain (e) walk: {m}")
    return aff.shape[0], float((got.double() - want).abs().max()), \
        f64_ms, f32_ms


def time_selftrain(torch, eng, memory, seng, peng, images, crf_model,
                   config):
    """(f) ms/image over `images` (normalized, with their labels), each
    stage ended by a synchronize: KNN MSC + CRF split into the device
    pyramid, the float16 download, the host resize and CRF; the softmax
    pyramid; the pseudo-label step split into forward (the softmax
    pyramid and the stride-8 embeddings), affinity, walk and CRF."""
    from spml_tpu_torch import cli
    from spml_tpu_torch.data import transforms
    from spml_tpu_torch.inference import msc, runner
    from spml_tpu_torch.ops import randomwalk

    t = dict.fromkeys(("pyramid", "download", "crf", "softmax", "forward",
                       "affinity", "walk", "pseudo_crf"), 0.0)

    def clock(key, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        t[key] += (time.perf_counter() - t0) * 1000 / len(images)
        return out

    c = config.dataset.num_classes
    for image0, sem in images:
        oh, ow = image0.shape[:2]
        image = runner._maybe_resize_input(eng.config, image0)[0]
        acc, n = clock("pyramid", msc._msc_accumulate_device, eng, image,
                       memory, MSC_SCALES, True)
        small = clock("download", lambda: acc.half().cpu().numpy())
        rgb = cli.denormalize_image(image0, config)
        clock("crf", lambda: crf_model(rgb, transforms._resize_image(
            small.astype(np.float32) / n, oh, ow).transpose(2, 0, 1)))
        clock("softmax", msc._msc_accumulate_device, seng, image, (),
              MSC_SCALES, True)
        h, w = image0.shape[:2]
        probs = clock("forward", msc.msc_predict_probs_device, peng, image0,
                      (), (1.0,), True)
        e = clock("forward", runner._stride8_embeddings, config,
                  peng.emb_model, image0)
        aff = clock("affinity", lambda: (randomwalk.pixel_affinity(e[0])
                                         + randomwalk.pixel_affinity(e[1]))
                    * 0.5)
        probs = runner._tag_mask(probs.transpose(2, 0, 1), sem, c)
        probs = probs / np.maximum(probs.max(axis=(1, 2), keepdims=True),
                                   1e-8)
        walked = clock("walk", runner._walk_scores, aff, probs,
                       (h // 8, w // 8))
        clock("pseudo_crf", crf_model, rgb, np.ascontiguousarray(walked))
    return t


def run_selftrain(torch, fused, dc, w):
    """The VOC scribble recipe after stage 1 (train_spml_scribble.sh:82-170)
    on the driver phase's world and snapshots, at full width: (a) KNN with
    MSC and CRF, and MSC alone; (b) softmax inference of the stage-2
    snapshot with and without MSC + CRF; (c) the recipe's pseudo-labels
    (pseudo_softmaxrw_crf) over the 24 training images, their mIoU, the
    list rewritten to them and 2 steps of train_classifier on it; (d)
    run_pseudo_knn, run_pseudo_camrw_crf (synthetic CAMs) and
    run_pseudo_densepose (a point-labelled world); (e) the card checks;
    (f) one [selftrain] line."""
    import argparse
    import copy
    from unittest import mock

    from spml_tpu_torch import cli, crf
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.data import datasets, synthetic
    from spml_tpu_torch.inference import engine, msc, runner
    from spml_tpu_torch.inference.softmax import SoftmaxInferenceEngine
    from spml_tpu_torch.train import densepose_point, driver

    t_phase = time.perf_counter()
    fused.reset_launch_counts()
    dc.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    root, stage1_dir, test4 = w.root, w.stage1_dir, w.lists["test"]
    infer = load_infer_config(w.stage1)
    c = infer.dataset.num_classes

    def args(snapshot, data_list, save, **extra):
        return argparse.Namespace(
            data_dir=w.data, data_list=data_list, snapshot_dir=snapshot,
            save_dir=os.path.join(root, "selftrain", save),
            semantic_memory_dir=w.bank, cam_dir=None, **CRF_FLAGS, **extra)

    # (a) KNN with MSC + CRF, and MSC alone with its sums recorded
    runs = {}
    runs["knn msc+crf"] = quiet(torch, runner.run_knn_inference,
                                args(stage1_dir, test4, "knn_msc_crf"),
                                infer, msc=True, crf=True, device=DEVICE)
    recorded = []
    resize_argmax = msc.resize_argmax

    def recording(acc, final_hw):
        recorded.append((acc.clone(), tuple(final_hw)))
        return resize_argmax(acc, final_hw)

    with mock.patch.object(msc, "resize_argmax", recording):
        runs["knn msc"] = quiet(torch, runner.run_knn_inference,
                                args(stage1_dir, test4, "knn_msc"), infer,
                                msc=True, device=DEVICE)
    read_pngs(os.path.join(root, "selftrain", "knn_msc_crf"), 4, c, "(a)")
    pixels, near = check_msc_labels(torch, recorded, read_pngs(
        os.path.join(root, "selftrain", "knn_msc"), 4, c, "(a)"))
    log("selftrain", f"(a) KNN MSC (scales {MSC_SCALES} x flips) + CRF and "
        f"MSC alone over 4 images: PNGs written; MSC labels equal the "
        f"float64 argmax of the resized float32 sums on {pixels - near} of "
        f"{pixels} pixels, {near} near-ties (gap < {MSC_TIE_GAP})")

    # (b) softmax inference of the stage-2 snapshot
    for name, kw in (("softmax msc+crf", dict(msc=True, crf=True)),
                     ("softmax", {})):
        save = name.replace(" ", "_").replace("+", "_")
        runs[name] = quiet(torch, runner.run_softmax_inference,
                           args(w.stage2_dir, test4, save), w.stage2,
                           device=DEVICE, **kw)
        read_pngs(os.path.join(root, "selftrain", save), 4, c, "(b)")
    log("selftrain", "(b) run_softmax_inference of the stage-2 snapshot "
        "(its frozen embedding from stage 1) over 4 images, MSC + CRF and "
        "single scale: PNGs written")

    # (c) the recipe's pseudo-labels, their mIoU, stage 2 on them
    pcfg = copy.deepcopy(infer)
    pcfg.network.kmeans_num_clusters = (1, 1)  # the recipe's flag
    pseudo = os.path.join(root, "selftrain", "pseudo_cam_rw")
    runs["pseudo softmax"] = quiet(
        torch, runner.run_pseudo_softmax, args(stage1_dir, w.list,
                                               "pseudo_cam_rw"), pcfg,
        with_crf=True, with_walk=True, scales=(1.0,), device=DEVICE)
    read_pngs(pseudo, WORLD_IMAGES, c, "(c)")
    with contextlib.redirect_stdout(None):
        miou = runner.run_benchmark(
            args(stage1_dir, w.list, "pseudo_cam_rw"), pcfg)["mean_iou"]
    if not (math.isfinite(miou) and 0.0 <= miou <= 1.0):
        raise AssertionError(f"selftrain (c): pseudo-label mIoU {miou}")
    with open(w.list) as f:  # the recipe's sed: labels -> pseudo-labels
        items = f.read().replace(
            "semantic/", os.path.join(pseudo, "semantic_gray") + "/")
    plist = os.path.join(pseudo, "list.txt")
    with open(plist, "w") as f:
        f.write(items)
    cls_cfg = copy.deepcopy(w.stage2)
    cls_cfg.train.max_iteration = 2
    with DriverProbe(torch) as probe:
        quiet(torch, driver.train_classifier,
              args(os.path.join(root, "softmax_classifier_stage1"), plist,
                   "unused"), cls_cfg, datasets.ListTagClassifierDataset,
              device=DEVICE)
    probe.check_finite("selftrain (c) classifier")
    if len(probe.metrics) != 2:
        raise AssertionError(f"selftrain (c): {len(probe.metrics)} stage-2 "
                             "steps, want 2")
    log("selftrain", f"(c) pseudo_softmaxrw_crf over {WORLD_IMAGES} images "
        f"(scales (1.0,) x flips, walk, CRF): mIoU {miou:.4f} against the "
        f"world's labels; the list rewritten to them; train_classifier 2 "
        f"steps, loss {probe.metrics[-1]['loss']:.4f}")

    # (d) the other pseudo-label paths
    runs["pseudo knn"] = quiet(torch, runner.run_pseudo_knn,
                               args(stage1_dir, test4, "pseudo_knn"), infer,
                               device=DEVICE)
    read_pngs(os.path.join(root, "selftrain", "pseudo_knn"), 4, c, "(d)")
    cams = os.path.join(root, "selftrain", "cams")
    synthetic.write_cams(cams, w.data, test4, num_classes=c, seed=0)
    camrw_args = args(stage1_dir, test4, "pseudo_camrw")
    camrw_args.cam_dir = cams
    runs["pseudo camrw"] = quiet(torch, runner.run_pseudo_camrw_crf,
                                 camrw_args, infer, device=DEVICE)
    read_pngs(camrw_args.save_dir, 4, c, "(d)")
    dp_data = os.path.join(root, "densepose")
    dp_list = synthetic.write_world(
        dp_data, 2, shapes=((427, 640), (640, 427)),
        num_classes=densepose_point.NUM_CLASSES, seed=0,
        points=DENSEPOSE_POINTS)
    dp_cfg = load_config(overrides=densepose_point.OVERRIDES)
    dp_cfg.network.kmeans_num_clusters = (24, 24)  # the recipe's flag
    dp_cfg.test.image_size = 640
    dp_cfg.test.crop_size = dp_cfg.test.stride = (640, 640)
    dp_args = args(os.path.join(root, "no_snapshot"), dp_list, "densepose")
    dp_args.data_dir = dp_data
    runs["pseudo densepose"] = quiet(torch, runner.run_pseudo_densepose,
                                     dp_args, dp_cfg, device=DEVICE)
    dp = read_pngs(dp_args.save_dir, 2, densepose_point.NUM_CLASSES, "(d)")
    for name, lab in dp.items():
        sem = datasets.read_label(os.path.join(dp_data, "semantic", name))
        if not ((lab == 255) == (sem == 255)).all():
            raise AssertionError(f"selftrain (d): {name}: the pixels "
                                 "without a point are not exactly the 255s")
    log("selftrain", "(d) run_pseudo_knn (scales (0.5, 1, 1.5, 2) x flips, "
        "tag mask, CRF, floor 0.15) and run_pseudo_camrw_crf over 4 images; "
        "run_pseudo_densepose over 2 images of 427 x 640 / 640 x 427 with "
        f"{DENSEPOSE_POINTS} points (panoptic_pspnet_101_densepose, seed 0, "
        "24 x 24 clusters, crop 640; train_spml_point.sh:49-53, 97-104): "
        "PNGs written, 255 exactly off the points")

    # (e) the card checks
    eng = engine.InferenceEngine(
        infer, cli.build_eval_models(infer, stage1_dir, DEVICE), DEVICE)
    memory = runner._load_memory(args(stage1_dir, test4, "unused"), infer,
                                 eng)
    seng = SoftmaxInferenceEngine(w.stage2, *cli.build_eval_models(
        w.stage2, w.stage2_dir, DEVICE, with_classifier=True), DEVICE)
    peng = SoftmaxInferenceEngine(pcfg, *cli.build_eval_models(
        pcfg, stage1_dir, DEVICE, with_classifier=True), DEVICE)
    items = [(img, sem) for _, _, img, sem, _ in cli.iterate_test_images(
        infer, w.data, test4)]
    probs = msc.msc_predict_probs_device(peng, items[0][0], (), (1.0,))
    n, walk_err, f64_ms, f32_ms = check_walk_float64(
        torch, pcfg, peng.emb_model, items[0][0],
        np.ascontiguousarray(probs.transpose(2, 0, 1)))
    crf_model = cli.crf_from_args(argparse.Namespace(**CRF_FLAGS))
    rgb = cli.denormalize_image(items[0][0], infer)
    unary = np.ascontiguousarray(probs.transpose(2, 0, 1))
    if not np.array_equal(crf_model(rgb, unary), crf_model(rgb, unary)):
        raise AssertionError("selftrain (e): the CRF gave two answers")
    pyramids = check_pyramids_card_against_cpu(torch)
    launches = {k: v for k, v in {**fused.LAUNCHES, **dc.LAUNCHES}.items()
                if v}
    if launches:
        raise AssertionError(f"selftrain (e): kernels launched: {launches}")
    log("selftrain", f"(e) checks ok: the walk at n = {n} (a 500 x 375 "
        f"image's grid) against float64 on the card, max_abs_err "
        f"{walk_err:.3e} (rtol {WALK_RTOL}; float32 {f32_ms:.2f} ms, "
        f"float64 {f64_ms:.2f} ms); card vs CPU float32 (crop 128, stride "
        f"64, 192 x 160, scales (0.75, 1) x flips): KNN members' clusters "
        f"equal but {pyramids['knn'][2]} k-means near-tie pixels (float64 "
        f"gap < {KMEANS_TIE_GAP}), outside the base pixels they feed the "
        f"probabilities' max_abs_err {pyramids['knn'][0]:.3e} (rtol "
        f"{KNN_PROB_RTOL}) and labels equal but {pyramids['knn'][1]} "
        "near-ties; softmax "
        f"{pyramids['softmax'][0]:.3e} (rtol {SOFTMAX_PROB_RTOL}), labels "
        f"equal but {pyramids['softmax'][1]} near-ties; the CRF the same "
        "twice; no SegSort or K10 launch in the phase")

    # (f) the split, on the 4 test images once more
    times = time_selftrain(torch, eng, memory, seng, peng, items, crf_model,
                           infer)
    peak = torch.cuda.max_memory_allocated()
    log("selftrain", "panoptic_deeplab_101 bf16, 4 images of 500 x 375 / "
        "375 x 500 (512 on the larger side for KNN and softmax), ms/image, "
        "each stage ended by a synchronize: KNN MSC + CRF "
        f"{times['pyramid'] + times['download'] + times['crf']:.2f} (device "
        f"pyramid {times['pyramid']:.2f}, float16 download "
        f"{times['download']:.2f}, host resize + CRF {times['crf']:.2f}); "
        f"softmax MSC pyramid {times['softmax']:.2f}; pseudo-label step "
        f"{sum(times[k] for k in PSEUDO_STAGES):.2f} (forward "
        f"{times['forward']:.2f}, affinity {times['affinity']:.2f}, walk "
        f"{times['walk']:.2f}, CRF {times['pseudo_crf']:.2f}); runner "
        "wall s, model build included: "
        + ", ".join(f"{k} {v[0]:.1f}" for k, v in runs.items())
        + f"; peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} held "
        f"as the phase began); phase {time.perf_counter() - t_phase:.1f} s; "
        f"card {nvidia_smi_line()}")


def loader_ms(cfg, dataset_cls, args, batches=8):
    """ms per batch of the driver's loader with nothing consuming it: the
    rate the host makes batches at, prefetch included."""
    from spml_tpu_torch.train import driver

    loader = driver._loader(args, cfg, dataset_cls)
    try:
        t0 = time.perf_counter()
        for _ in range(batches):
            next(loader)
        return (time.perf_counter() - t0) * 1000 / batches
    finally:
        loader.close()


def load_infer_config(stage1):
    """The inference config of the stage-1 snapshot
    (train_spml_scribble.sh:86-100: --kmeans_num_clusters 12,12,
    --label_divisor 2048)."""
    import copy

    cfg = copy.deepcopy(stage1)
    cfg.network.kmeans_num_clusters = (12, 12)
    return cfg


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
    run_inference(torch)
    run_driver(torch, fused, dc)

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
