"""The train step's model FLOPs (portbench/flops.py::train_step_flops:
every conv once forward, each trained conv twice more backward, no
recomputation) over the untraced steps' time in the trace run, on the
host clock, against the bf16 dense peak of 989 TFLOP/s, in %."""

from portbench.flops import PEAK_BF16


def read(traced):
    if not traced["untraced_items"] or not traced["untraced_s"]:
        return None
    return (100.0 * traced["flops_per_item"] * traced["untraced_items"]
            / (traced["untraced_s"] * PEAK_BF16))
