"""SPML in PyTorch and CUDA for NVIDIA Hopper.

The port of the JAX package ``spml_tpu`` (which stays in the repository as
the reference). Module paths mirror the JAX package so that each function
can be found beside its counterpart; the port imports nothing from it.

Public functions keep the JAX layouts at their boundary: images and
embeddings NHWC, labels [B, H, W]. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; the SegSort loss kernels of
the flagship and DensePose train steps are hand-written CUDA
(``csrc/``), built with nvcc at first use.
"""
