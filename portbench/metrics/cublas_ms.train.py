"""Device ms a train step in cuBLAS products, which k-means' one-hot
sums and the float32 segment sums lead (the matmul category of
portbench/trace.py)."""


def read(traced):
    ms = traced["trace"].ms_by_category().get("matmul (cuBLAS)")
    return None if ms is None else ms / traced["items"]
