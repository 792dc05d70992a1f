"""Device operations an image: the kernels, copies and sets of the
host-and-device profile whose launch lies inside the program's
spml.infer.image span (spml_tpu_torch/inference/engine.py::
predict_semantic), over the profile's images; nothing where the program
opens no such span."""

from portbench.spans import count_under_span


def read(traced):
    ops = count_under_span(traced["host_trace"], "spml.infer.image")
    return None if ops is None else ops / traced["host_items"]
