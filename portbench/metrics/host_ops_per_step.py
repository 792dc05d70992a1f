"""Host operators a train step: the profiler's cpu_op events over the
steps of the host-and-device profile."""


def read(traced):
    ops = traced["host_trace"].cpu_ops
    return len(ops) / traced["host_items"] if ops else None
