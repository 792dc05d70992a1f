"""Visualization helpers: label colorization and PCA-RGB embeddings.

The port's own copy of spml_tpu/utils/vis.py (numpy; scipy only to read a
.mat colormap). Behavioral reference: spml/utils/general/vis.py:41-101 in
twke18/SPML.
The VOC colormap is generated algorithmically (bit-interleave) instead of
loading misc/colormapvoc.mat — identical values to the standard VOC
palette the .mat encodes.
"""

from __future__ import annotations

import numpy as np


def voc_colormap(n: int = 256) -> np.ndarray:
    """Standard PASCAL VOC colormap, [n, 3] uint8."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        cid = i
        for j in range(8):
            r |= ((cid >> 0) & 1) << (7 - j)
            g |= ((cid >> 1) & 1) << (7 - j)
            b |= ((cid >> 2) & 1) << (7 - j)
            cid >>= 3
        cmap[i] = (r, g, b)
    return cmap


def load_color_map(path: str | None = None) -> np.ndarray:
    """Load a colormap .mat (reference format) or fall back to the
    generated VOC palette."""
    if path:
        try:
            import scipy.io
            mat = scipy.io.loadmat(path)
            for v in mat.values():
                if isinstance(v, np.ndarray) and v.ndim == 2 \
                        and v.shape[1] == 3:
                    arr = v
                    if arr.dtype != np.uint8:
                        arr = (arr * 255).astype(np.uint8)
                    return arr
        except (OSError, ValueError):
            pass
    return voc_colormap()


def label_to_color(label: np.ndarray, colormap: np.ndarray | None = None
                   ) -> np.ndarray:
    if colormap is None:
        colormap = voc_colormap()
    return colormap[np.clip(label, 0, len(colormap) - 1)]


def embedding_to_rgb(embedding: np.ndarray) -> np.ndarray:
    """[..., D] -> [..., 3] uint8: the first three principal components
    (float64 SVD), each scaled to [0, 255] (vis.py:62-101)."""
    shape = embedding.shape
    flat = embedding.reshape(-1, shape[-1]).astype(np.float64)
    flat = flat - flat.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:3].T
    lo, hi = proj.min(0, keepdims=True), proj.max(0, keepdims=True)
    rgb = (proj - lo) / np.maximum(hi - lo, 1e-12)
    return (rgb.reshape(*shape[:-1], 3) * 255).astype(np.uint8)
