"""Host-side image and label resizes of inference (numpy; PIL for the
bilinear image resize only).

The port's own copy of spml_tpu/data/transforms.py (reference:
spml/data/transforms.py in twke18/SPML, resize_with_interpolation:98,
resize_with_pad:122). PIL is imported inside _resize_image alone, so the
engine imports and runs on a host without it. The training augmentations
are not ported yet.
"""

from __future__ import annotations

import numpy as np


def _resize_image(image: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bilinear float32 resize of [H, W] or [H, W, C] (PIL's BILINEAR
    filter, each channel as a mode-F image)."""
    import PIL.Image

    def one(channel):
        pil = PIL.Image.fromarray(channel.astype(np.float32), mode="F")
        return np.asarray(pil.resize((new_w, new_h), PIL.Image.BILINEAR),
                          np.float32)

    if image.ndim == 2:
        return one(image)
    return np.stack([one(image[..., c]) for c in range(image.shape[-1])],
                    axis=-1)


def _resize_nearest(label: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Nearest resize: src = floor(dst * in / out), in float64."""
    h, w = label.shape[:2]
    ys = np.floor(np.arange(new_h) * (h / new_h)).astype(np.int64)
    xs = np.floor(np.arange(new_w) * (w / new_w)).astype(np.int64)
    return label[ys][:, xs]


def resize_with_interpolation(image, larger_size, method="bilinear"):
    """Scale so the larger side equals `larger_size` (reference :98)."""
    h, w = image.shape[:2]
    ratio = min(float(larger_size) / h, float(larger_size) / w)
    new_h, new_w = int(ratio * h), int(ratio * w)
    if method == "bilinear":
        return _resize_image(image, new_h, new_w)
    return _resize_nearest(image, new_h, new_w)


def resize_with_pad(image, size, image_pad_value=0, pad_mode="left_top"):
    """Pad up to `size` (never crop) with a scalar or per-channel value;
    "left_top" keeps the image at the top left, "center" centres it."""
    h, w = image.shape[:2]
    new_shape = list(image.shape)
    new_shape[0] = max(h, size[0])
    new_shape[1] = max(w, size[1])
    pad = np.zeros(new_shape, dtype=image.dtype)
    if np.isscalar(image_pad_value):
        pad.fill(image_pad_value)
    else:
        for c, val in enumerate(image_pad_value):
            pad[:, :, c].fill(val)
    if pad_mode == "center":
        sy = (new_shape[0] - h) // 2
        sx = (new_shape[1] - w) // 2
        pad[sy:sy + h, sx:sx + w, ...] = image
    elif pad_mode == "left_top":
        pad[:h, :w, ...] = image
    else:
        raise ValueError("Unsupported padding mode")
    return pad
