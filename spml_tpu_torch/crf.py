"""Dense CRF post-processing on the host: ctypes over native/densecrf/.

Port of spml_tpu/crf.py (reference: spml/models/crf.py:14-41 in
twke18/SPML, a pydensecrf DenseCRF2D: a Gaussian pairwise term (pos_xy_std,
pos_w) and a bilateral one (bi_xy_std, bi_rgb_std, bi_w) over a softmax
unary, iter_max mean-field iterations, on the permutohedral lattice).

The port builds its own library from native/densecrf/{permutohedral,
densecrf}.cc at first use, with g++ and the flags of
native/densecrf/Makefile, into spml_tpu_torch/_build/ under a name that
digests the sources, the flags and what -march=native means on this host
(a library built for another CPU is never loaded). The tracked
native/densecrf/libdensecrf.so is neither loaded nor rebuilt. A failed
build raises; there is no other CRF. The library runs its loops on
OpenMP threads and ctypes drops the GIL during a call, so callers may run
CRFs on a thread pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
NATIVE = _PKG.parent / "native" / "densecrf"
SOURCES = ("permutohedral.cc", "densecrf.cc")
HEADERS = ("permutohedral.h",)
BUILD_DIR = _PKG / "_build"
# native/densecrf/Makefile:2
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native",
            "-fopenmp", "-fno-math-errno", "-fno-trapping-math", "-shared"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FP, UP = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte)
# (restype, argtypes) of every exported C function of densecrf.cc
SIGNATURES = {
    "crf2d_new": (P, [I, I, I]),  # w, h, c
    "crf2d_free": (None, [P]),
    "crf2d_set_unary_from_probs": (None, [P, FP]),  # probs [C, H, W]
    "crf2d_add_pairwise_gaussian": (None, [P, F, F, F]),  # sx, sy, w
    # sx, sy, sr, sg, sb, rgb [H, W, 3] uint8, weight
    "crf2d_add_pairwise_bilateral": (None, [P, F, F, F, F, F, UP, F]),
    "crf2d_inference": (None, [P, I, FP]),  # n_iter, out [C, H, W]
}

_lib = None
_lock = threading.Lock()


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the DenseCRF library of "
                           "spml_tpu_torch is built from source at first use")
    return found


def _native_flags(gxx: str) -> str:
    """The target options -march=native expands to on this host (cc1's
    -m flags and cache parameters)."""
    out = subprocess.run([gxx, "-march=native", "-E", "-v", "-"],
                         input="", capture_output=True, text=True,
                         check=True).stderr
    cc1 = next(ln.split() for ln in out.splitlines()
               if ln.split() and ln.split()[0].endswith("cc1"))
    return " ".join(t for t in cc1 if t.startswith(("-m", "l1-", "l2-")))


def target(gxx: str) -> Path:
    """The library's path: a digest of the sources, the flags and this
    host's -march=native."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((NATIVE / name).read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(_native_flags(gxx).encode())
    return BUILD_DIR / f"libdensecrf-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; returns its path."""
    gxx = _gxx()
    out = target(gxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [gxx, *CXXFLAGS, "-o", str(tmp), *(str(NATIVE / s) for s in SOURCES)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for native/densecrf:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The bound library, built and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, (restype, argtypes) in SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _lib = lib
        return _lib


class DenseCRF:
    """The reference wrapper's constructor (crf.py:14) and call."""

    def __init__(self, iter_max=10, pos_w=3, pos_xy_std=1, bi_w=4,
                 bi_xy_std=67, bi_rgb_std=3):
        self.iter_max = int(iter_max)
        self.pos_w = float(pos_w)
        self.pos_xy_std = float(pos_xy_std)
        self.bi_w = float(bi_w)
        self.bi_xy_std = float(bi_xy_std)
        self.bi_rgb_std = float(bi_rgb_std)

    def __call__(self, image: np.ndarray, probmap: np.ndarray) -> np.ndarray:
        """image [H, W, 3] uint8, probmap [C, H, W] probabilities; returns
        the refined [C, H, W] float32 marginals."""
        lib = load()
        c, h, w = probmap.shape
        if image.shape != (h, w, 3):
            raise ValueError(f"image {image.shape} does not match the "
                             f"probabilities {probmap.shape}")
        probs = np.ascontiguousarray(probmap, np.float32)
        rgb = np.ascontiguousarray(image, np.uint8)
        out = np.empty((c, h, w), np.float32)
        handle = lib.crf2d_new(w, h, c)
        try:
            lib.crf2d_set_unary_from_probs(handle, probs.ctypes.data_as(FP))
            lib.crf2d_add_pairwise_gaussian(handle, self.pos_xy_std,
                                            self.pos_xy_std, self.pos_w)
            lib.crf2d_add_pairwise_bilateral(
                handle, self.bi_xy_std, self.bi_xy_std, self.bi_rgb_std,
                self.bi_rgb_std, self.bi_rgb_std, rgb.ctypes.data_as(UP),
                self.bi_w)
            lib.crf2d_inference(handle, self.iter_max,
                                out.ctypes.data_as(FP))
        finally:
            lib.crf2d_free(handle)
        return out
