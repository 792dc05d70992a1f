"""Device ms a train step in cuDNN's convolutions and the batch norms
(the conv and batch-norm categories of portbench/trace.py); nothing
where either category is empty, never the other alone."""


def read(traced):
    ms = traced["trace"].ms_by_category()
    if "conv (cuDNN)" not in ms or "batch norm" not in ms:
        return None
    return (ms["conv (cuDNN)"] + ms["batch norm"]) / traced["items"]
