"""The embedding forward's model FLOPs of each prediction
(portbench/flops.py::forward_flops) over the untraced predictions' time
in the trace run, on the host clock, against the bf16 dense peak of 989
TFLOP/s, in %."""

from portbench.flops import PEAK_BF16


def read(traced):
    if not traced["untraced_items"] or not traced["untraced_s"]:
        return None
    return (100.0 * traced["flops_per_item"] * traced["untraced_items"]
            / (traced["untraced_s"] * PEAK_BF16))
