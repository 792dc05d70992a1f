"""Host ms an image inside the program's spml.infer.upload span
(spml_tpu_torch/inference/engine.py::upload_image: the host pad, the
copy up and the cast), over the images of the host-and-device profile,
on the profiler's clock (the profile slows the host); nothing where the
program opens no such span."""


def read(traced):
    spans = traced["host_trace"].spans.get("spml.infer.upload")
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / traced["host_items"]
