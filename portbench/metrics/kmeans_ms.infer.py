"""Device ms an image of the work launched inside the benchmark's
portbench.segment span, around the engine instance's segment call
(the host-and-device profile's images)."""


def read(traced):
    ms = traced["host_trace"].ms_under_span("portbench.segment")
    return None if ms is None else ms / traced["host_items"]
