"""Device ms an image of the work launched inside the benchmark's
portbench.retrieve span, around the engine instance's retrieve call
(the host-and-device profile's images)."""


def read(traced):
    ms = traced["host_trace"].ms_under_span("portbench.retrieve")
    return None if ms is None else ms / traced["host_items"]
