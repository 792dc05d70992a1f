"""Build and bind the hand-written CUDA kernels of spml_tpu_torch/csrc.

Each ``csrc/<name>.cu`` exports a plain C interface. At first use it is
compiled with nvcc for sm_90a into ``spml_tpu_torch/_build/`` (one
library per source and content hash, so an edited source rebuilds) and
loaded with ctypes. Sources build in parallel, one nvcc each. Nothing here
runs at import: the CPU tests import every module on hosts without nvcc.

A failed build raises; there is no fallback to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every exported C function, by source
SIGNATURES = {
    "segsort_joint": {
        # emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
        # proto_valid, num_valid, n, p, d, kappa_a, kappa_o, square,
        # out [6, N], stream
        "segsort_joint_stats": [P] * 9 + [I, I, I, F, F, I, P, P],
        # ... the same 15 + grads [6, N], d_emb [N, D], stream
        "segsort_joint_grad_emb": [P] * 9 + [I, I, I, F, F, I, P, P, P],
        # ... the same 15 + grads [6, N], partial [blocks, 128, D],
        # blocks, d_protos [P, D], stream
        "segsort_joint_grad_proto":
            [P] * 9 + [I, I, I, F, F, I, P, P, I, P, P],
        # emb, pix_lab, own, protos, proto_lab, num_valid, n, p, d, kappa,
        # out [3, N], stream
        "segsort_hard_stats": [P] * 6 + [I, I, I, F, P, P],
        # ... the same 10 + grads [3, N], d_emb [N, D], stream
        "segsort_hard_grad_emb": [P] * 6 + [I, I, I, F, P, P, P],
        # ... the same 10 + grads [3, N], partial [blocks, 128, D],
        # blocks, d_protos [P, D], stream
        "segsort_hard_grad_proto":
            [P] * 6 + [I, I, I, F, P, P, I, P, P],
        # emb, pix_tag, own, protos, proto_tag, proto_valid, num_valid, n,
        # p, d, kappa, out [3, N], stream
        "segsort_set_stats": [P] * 7 + [I, I, I, F, P, P],
        # ... the same 11 + grads [3, N], d_emb [N, D], stream
        "segsort_set_grad_emb": [P] * 7 + [I, I, I, F, P, P, P],
        # ... the same 11 + grads [3, N], partial [blocks, 128, D],
        # blocks, d_protos [P, D], stream
        "segsort_set_grad_proto":
            [P] * 7 + [I, I, I, F, P, P, I, P, P],
    },
    "dilated_conv": {
        # x [B, H, W, C], w [3, 3, C, O], out [B, H, W, O] (bf16), B, H,
        # W, C, O, dilation, stream
        "dilated_conv3x3_bf16": [P] * 3 + [I] * 6 + [P],
    },
    "knn_topk": {
        # emb [N, D], bank [P, D], mask [P] (bool) or null, n, p, d, k,
        # chunks, rows_per_chunk, scratch [2, chunks, N, k], stream
        "knn_topk_partial": [P] * 3 + [I] * 6 + [P, P],
        # scratch, labels [P], label bytes, n, p, k, chunks, out [N, k],
        # stream
        "knn_topk_merge": [P, P] + [I] * 5 + [P, P],
    },
}
# the SegSort kernels' bf16-operand forms (emb and protos bf16, the rest
# as the float32 forms')
SIGNATURES["segsort_joint"].update(
    {f"{fn}_bf16": sig for fn, sig in SIGNATURES["segsort_joint"].items()})

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of spml_tpu_torch "
                       "are built from source at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every named source that has no up-to-date library, all
    nvcc processes started together. Returns {name: ptxas report}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        reports[name] = log
    for name in names:
        if name not in reports:
            log = _target(name).with_suffix(".log")
            reports[name] = log.read_text() if log.exists() else ""
    return reports


def load(name: str) -> ctypes.CDLL:
    """The bound library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            out = _target(name)
            if not out.exists():
                build((name,))
            lib = ctypes.CDLL(str(out))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on `device`, as the raw handle."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
