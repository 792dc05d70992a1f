"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json and the port
(spml_tpu_torch). The cell's entry in BENCHMARK.json names its
configuration (portbench/configs/<config>.json) and traffic
(portbench/workloads/<traffic>.json); the traffic's "driver" names the
loop that runs it (portbench/drivers/). Needs as many CUDA cards as the
cell asks for, and never falls back to the CPU.

The run sets up, warms up, measures for --seconds and checks the timed
path's outputs against the plain reference (portbench/reference/). Its
last line on standard output is one JSON object: correct, attempted,
failed, metrics (with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, each read by
portbench/metrics/<name>.py), device, with --trace 1 breakdown, and last
checks: each number compared with its limit, which also close standard
error. It exits non-zero with no result if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "spml_tpu")
CACHE = ROOT / ".portbench_cache"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """{entry, config, traffic, limits} of the cell `name`, its files
    found by the names in `bench` under the checkout `root`."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic = load_json(root / "portbench" / "workloads"
                        / f"{entry['traffic']}.json")
    return {"entry": entry, "config": load_json(root / config["file"]),
            "traffic": traffic, "limits": traffic.get("limits", {})}


def applies(metric: dict, cell: str, reported=()) -> bool:
    """Whether `cell` reports `metric`: listed under its workloads, or
    without such a list, wherever the end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_metric(name: str, root: Path = ROOT):
    """portbench/metrics/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        root / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loaded_forbidden() -> list[str]:
    """Modules of JAX or the JAX package in this process, by whole
    top-level name."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = (limit is not None and not math.isnan(value)
                and value <= limit)
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(bench, args.workload)
    chips = cell["entry"]["chips"]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    driver = importlib.import_module(
        f"portbench.drivers.{cell['traffic']['driver']}")
    device = torch.device("cuda", 0)
    got = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     T0)

    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    ok, checks = judge(got["numbers"], cell["limits"])
    correct = ok and got["failed"] == 0
    name = args.workload
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": got["peak_bytes"],
                   "power_limit": power_limit()}
    metrics, result = {}, {}
    if not args.trace:
        values = dict(got.get("metrics", {}),
                      peak_mem_gib=got["peak_bytes"] / 2 ** 30,
                      setup_s=got["setup_s"])
        for m in bench["end_to_end"]:
            if applies(m, name):
                if m["name"] not in values:
                    print(f"portbench: {name} read no {m['name']}",
                          file=sys.stderr)
                    return 4
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        traced = got["trace"]
        tr = traced["trace"]
        device_info.update(busy_s=tr.busy_s(), window_s=traced["window_s"])
        reported = [m["name"] for m in bench["end_to_end"]
                    if applies(m, name)]
        for m in bench["per_layer"]:
            if not applies(m, name, reported):
                continue
            value = load_metric(m["name"]).read(traced)
            if value is None:  # its source is empty: left out, said so
                print(f"portbench: per-layer metric {m['name']} read "
                      f"nothing in {name}: left out of the line",
                      file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": traced["host_trace"].idle_gaps()}
    print(f"portbench: {name} seed {args.seed}: {got['attempted']} "
          f"attempted, {got['failed']} failed, set-up "
          f"{got['setup_s']:.3f} s, window {got['window_s']:.3f} s"
          + (f", {len(got['step_ms'])} steps timed" if "step_ms" in got
             else ""), file=sys.stderr)
    for k, v in got.get("info", {}).items():
        print(f"not compared: {k} {v!r}", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    line = {"correct": correct, "attempted": got["attempted"],
            "failed": got["failed"], "metrics": metrics,
            "device": device_info, **result, "checks": checks}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
