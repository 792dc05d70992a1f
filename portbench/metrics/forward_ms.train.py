"""Device ms a train step of the work launched inside the program's
spml.train.forward span (spml_tpu_torch/train/step.py::make_train_step:
the embedding network and the label resizes), over the steps of the
host-and-device profile; nothing where the program opens no such span."""


def read(traced):
    ms = traced["host_trace"].ms_under_span("spml.train.forward")
    return None if ms is None else ms / traced["host_items"]
