"""Visualization helpers: label colorization.

The port's own copy of spml_tpu/utils/vis.py (numpy; scipy only to read a
.mat colormap). embedding_to_rgb is not ported yet. Behavioral reference:
spml/utils/general/vis.py:41-61 in twke18/SPML.
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
