"""Where a train step's device time goes.

    python -m spml_tpu_torch.tools.profile_step [--recipe flagship |
        densepose_point | voc_tag]
        [--steps 3] [--out DIR] [--remat-stages 3,4,5]

Needs one CUDA card. Builds the recipe's configuration from seed 0 —
flagship (spml_tpu_torch/train/flagship.py, blobby synthetic labels),
densepose_point (spml_tpu_torch/train/densepose_point.py, synthetic point
labels) or voc_tag (spml_tpu_torch/train/voc_tag.py, the flagship's
blobby labels), with tpu.remat_stages set to --remat-stages (default
none) — runs 3 warm-up steps, times 5 steps with CUDA events, then
traces --steps steps with torch.profiler (CPU + CUDA activity) and
prints:

* step ms untraced and traced (CUDA events), images/s;
* device busy ms per step (union of kernel, copy and set intervals) and
  the device's idle share of the traced steps; host operators per step;
* device ms per step by kernel category (name patterns below) and the
  15 kernels that take the most time.

The Chrome trace goes to DIR/profile_step_<recipe>_trace.json (default
profile_out/).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

import torch

from spml_tpu_torch.train import recipes

CATEGORIES = [  # first match wins; cuDNN's conv kernels also say "gemm"
    # the kernels of csrc/segsort_joint.cu (K1-K3 joint, K4-K6 hard,
    # K7-K9 set)
    ("segsort loss K1-K9", r"(grad_tile|stats_tile)_kernel<|reduce_tiles"),
    ("conv (cuDNN)", r"fprop|dgrad|wgrad|implicit|conv|cudnn|"
                     r"nchwToNhwc|nhwcToNchw"),
    ("matmul (cuBLAS)", r"gemm|gemv|Gemm|nvjet|splitK"),
    ("batch norm", r"batch_norm|bn_|welford|Welford"),
    ("resize / pool / softmax", r"upsample|pool|softmax"),
    ("sort / scan", r"[Ss]ort|scan|Scan|cub::"),
    ("optimizer (foreach)", r"multi_tensor_apply"),
    ("reduction", r"reduce_kernel|Reduce"),
    ("index / scatter / gather", r"index|scatter|gather|Index|Scatter"),
    ("elementwise", r"elementwise|Elementwise|vectorized"),
    ("copy / memset", r"Memcpy|Memset|memcpy|memset|copy"),
]


def _category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def _busy_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _time_steps(train_step, state, batch, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state, metrics = train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return state, start.elapsed_time(end) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--recipe", choices=list(recipes.RECIPES),
                    default="flagship")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--remat-stages", default="",
                    help="backbone stages to checkpoint, e.g. 3,4,5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")

    from spml_tpu_torch.train import step as step_lib

    cfg, batch = recipes.setup(args.recipe)
    cfg.tpu.remat_stages = tuple(int(x) for x in args.remat_stages.split(",")
                                 if x)
    b = cfg.train.batch_size
    state = step_lib.init_state(cfg, 0, batch["image"], device="cuda")
    train_step = step_lib.make_train_step(cfg)
    state, _ = _time_steps(train_step, state, batch, 3)
    state, plain_ms = _time_steps(train_step, state, batch, 5)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, traced_ms = _time_steps(train_step, state, batch, args.steps)
    os.makedirs(args.out, exist_ok=True)
    remat = "_remat" + "".join(map(str, cfg.tpu.remat_stages)) \
        if cfg.tpu.remat_stages else ""
    path = os.path.join(args.out,
                        f"profile_step_{args.recipe}{remat}_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise SystemExit("profile_step: the trace holds no device events")
    host_ops = sum(e.get("ph") == "X" and e.get("cat") == "cpu_op"
                   for e in events)

    n = args.steps
    busy_ms = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in dev]) \
        / 1e3 / n
    by_cat, by_name = {}, {}
    for e in dev:
        by_cat[_category(e["name"])] = by_cat.get(
            _category(e["name"]), 0.0) + e["dur"] / 1e3 / n
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3 / n
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"recipe: {args.recipe}; remat stages "
          f"{cfg.tpu.remat_stages or 'none'}; card: {smi}; torch "
          f"{torch.__version__}")
    print(f"step: {plain_ms:.2f} ms untraced ({b * 1000 / plain_ms:.2f} "
          f"imgs/s), {traced_ms:.2f} ms traced; device busy "
          f"{busy_ms:.2f} ms/step, idle share "
          f"{1 - busy_ms / traced_ms:.3f} of the traced steps; "
          f"{len(dev) / n:.0f} device events/step, {host_ops / n:.0f} host "
          "operators/step")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:28s} {ms:8.3f} ms/step")
    print("top kernels (ms/step):")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:8.3f}  {name[:110]}")
    print(f"trace: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
