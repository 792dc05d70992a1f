"""Device operations a train step: the kernels, copies and sets of the
host-and-device profile whose launch lies inside the program's
spml.train.step span (spml_tpu_torch/train/step.py::make_train_step),
over the profile's steps; nothing where the program opens no such
span."""

from portbench.spans import count_under_span


def read(traced):
    ops = count_under_span(traced["host_trace"], "spml.train.step")
    return None if ops is None else ops / traced["host_items"]
