"""Device ms a train step of the work launched inside the program's
spml.train.kmeans span (spml_tpu_torch/train/step.py::make_train_step:
ops/kmeans.py::segment_batch), over the steps of the host-and-device
profile; nothing where the program opens no such span."""


def read(traced):
    ms = traced["host_trace"].ms_under_span("spml.train.kmeans")
    return None if ms is None else ms / traced["host_items"]
