"""The SegSort loss kernels' share of their roofline: the least time the
traced steps' losses could take (portbench/flops.py::segsort_bound_ms,
from each call's pixels, carrying rows, valid prototypes and width, as
drivers/train.py::SegsortWork reads them by the losses' parameter names)
over the device time of the kernels of csrc/segsort_joint.cu, in %.
Nothing where the steps made no call it could read or the kernels ran
under other names."""


def read(traced):
    bound = traced.get("segsort_bound_ms")
    ms = traced["trace"].ms_by_category().get("segsort loss K1-K9")
    if not bound or not ms:
        return None
    return 100.0 * bound / ms
