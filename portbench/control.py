"""The readings each cell's limits are set from: the program's, the
control's and the planted faults', over many seeds in one process.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3
        [--controls reference_fp8,...] [--faults half_batch,...]
        [--seconds 2]

For each seed, one run of the cell's driver at its own size (a window of
--seconds: training's long enough to pass the learning rate's warm-up,
so that the step after it is checked as in a full run; inference's a
short one at the cell's own load), then each control and each fault on
that seed. A training control is the reference in the lower precision,
put in the program's place at both checked stages: the first steps from
the seed and the step after the window from the program's copy. Prints one JSON
line a reading, {seed, arm, numbers}. Needs a CUDA card.

Controls, each one step below the precision the configuration states
(bf16 convolutions, float32 products with TF32 off), put in the
program's place:
* reference_fp8: the reference with every bf16 conv's operands rounded
  to float8 e4m3 (per-tensor scale);
* reference_tf32: the reference with TF32 on for its float32 products;
* program_bf16_operands (training): the program's own lower path,
  tpu.loss_operand_dtype = "bfloat16" for the SegSort kernels.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import torch

from portbench import checks, faults, run as run_lib
from portbench import traffic as traffic_lib
from portbench.drivers import knn_infer, train
from portbench.reference import infer as ref_infer
from portbench.reference import model as ref_model


def program(cell, seed, seconds, device, keep=False):
    """The numbers of one run of the cell's driver, those printed beside
    them too; with keep (training), also what the controls reuse."""
    driver = train if cell["traffic"]["driver"] == "train" else knn_infer
    kw = {"keep": True} if keep else {}
    got = driver.run(cell, seed, seconds, False, device, time.perf_counter(),
                     **kw)
    numbers = dict(got["numbers"], **got.get("info", {}))
    return (numbers, got.get("kept")) if keep else numbers


def train_control(cell, seed, arm, device, kept) -> dict:
    """A control's numbers on `seed`; kept: what the program's run on it
    kept (the ring, the reference's readings, the copy of the state the
    window left): the lower reference starts from the same."""
    if arm == "program_bf16_operands":
        cell = copy.deepcopy(cell)
        cell["config"]["overrides"]["tpu"]["loss_operand_dtype"] = "bfloat16"
        return program(cell, seed, kept["seconds"], device)
    over = cell["config"]["overrides"]
    lower = {"reference_fp8": {"lower": "fp8"},
             "reference_tf32": {"tf32": True}}[arm]
    low = train.reference_run(over, seed, kept["ring"], device, **lower)
    numbers, info = checks.train_numbers(low, kept["ref"], kept["p0"])
    low_w = train.reference_window(over, kept["copy"], kept["batch_w"],
                                   device, **lower)
    numbers.update(checks.window_numbers(low_w, kept["ref_w"],
                                         over["train"]["momentum"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dict(numbers, **info)


def infer_control(cell, seed, arm, device, kept=None) -> dict:
    over, traffic = cell["config"]["inference_overrides"], cell["traffic"]
    c = over["dataset"]["num_classes"]
    pool = traffic_lib.inference_images(traffic, seed, c,
                                        over["network"]["pixel_means"],
                                        over["network"]["pixel_stds"])
    bank = traffic_lib.make_bank(seed, traffic["bank_rows"],
                                 over["network"]["embedding_dim"], c, device)
    w = knn_infer.weights(over, seed, device)
    kind = over["network"]["backbone_types"]

    def outputs(lower, tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        net = ref_model.Net(w, kind, train=False, lower=lower)
        return [{k: v.cpu() for k, v in ref_infer.predict(
            net, im, over, bank, device).items()} for im in pool]

    ref = outputs(None, False)
    lower = {"reference_fp8": (("fp8", False)),
             "reference_tf32": (None, True),
             "reference_fp8_tf32": ("fp8", True)}[arm]
    low = outputs(*lower)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return checks.infer_numbers(low, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = run_lib.load_json(run_lib.ROOT / "BENCHMARK.json")
    cell = run_lib.load_cell(bench, args.workload)
    is_train = cell["traffic"]["driver"] == "train"
    control = train_control if is_train else infer_control
    for seed in (int(s) for s in args.seeds.split(",")):
        kept = {}

        def prog():
            if not is_train:
                return program(cell, seed, args.seconds, device)
            numbers, got = program(cell, seed, args.seconds, device, True)
            kept.update(got, seconds=args.seconds)
            return numbers
        arms = [("program", prog)]
        arms += [(a, lambda a=a: control(cell, seed, a, device, kept))
                 for a in args.controls.split(",") if a]
        for f in (f for f in args.faults.split(",") if f):
            def planted(f=f):
                with faults.FAULTS[f]():
                    return program(cell, seed, args.seconds, device)
            arms.append((f"fault_{f}", planted))
        for arm, fn in arms:
            t = time.perf_counter()
            try:
                numbers = fn()
            except Exception as e:  # a control that crashes has failed
                numbers = {"error": f"{type(e).__name__}: {e}"[:300]}
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "arm": arm, "numbers": numbers,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
