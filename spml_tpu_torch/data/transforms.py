"""Host-side image and label transforms (numpy; PIL for the bilinear
image resize, scipy for the blur).

The port's own copy of spml_tpu/data/transforms.py (reference:
spml/data/transforms.py in twke18/SPML: resize:8, random_resize:40,
mirror:65, resize_with_interpolation:98, resize_with_pad:122,
random_crop_with_pad:158; the classifier augmentations of
list_tag_dataset.py:193-214). Every random draw comes from the
np.random.Generator passed in, in the JAX package's order. PIL and scipy
are imported inside the functions that use them, so the inference
engine imports and runs on a host without them.
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


def resize(image, label, ratio, image_method="bilinear",
           label_method="nearest"):
    """Both scaled by `ratio` (sizes truncated to int)."""
    h, w = image.shape[:2]
    new_h, new_w = int(ratio * h), int(ratio * w)
    new_image = (_resize_image(image, new_h, new_w)
                 if image_method == "bilinear"
                 else _resize_nearest(image, new_h, new_w))
    new_label = (_resize_nearest(label, new_h, new_w)
                 if label_method == "nearest"
                 else _resize_image(label, new_h, new_w))
    return new_image, new_label


def random_resize(rng: np.random.Generator, image, label,
                  scale_min=1.0, scale_max=1.0):
    """resize by a ratio drawn from U(scale_min, scale_max)."""
    ratio = rng.uniform(scale_min, scale_max)
    return resize(image, label, ratio)


def mirror(image, label):
    """Horizontal flip (views)."""
    return image[:, ::-1, ...], label[:, ::-1, ...]


def random_mirror(rng: np.random.Generator, image, label):
    """mirror when a U(0, 1) draw is >= 0.5."""
    if rng.uniform(0, 1.0) >= 0.5:
        return mirror(image, label)
    return image, label


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


def random_crop_with_pad(rng: np.random.Generator, image, label, crop_size,
                         image_pad_value=0, label_pad_value=255,
                         pad_mode="left_top"):
    """Pad both up to crop_size (image with image_pad_value, label with
    label_pad_value), then crop at a corner drawn as floor(U(0, h - ch))
    and floor(U(0, w - cw)), in that order."""
    image = resize_with_pad(image, crop_size, image_pad_value, pad_mode)
    label = resize_with_pad(label, crop_size, label_pad_value, pad_mode)
    h, w = image.shape[:2]
    start_h = int(np.floor(rng.uniform(0, h - crop_size[0])))
    start_w = int(np.floor(rng.uniform(0, w - crop_size[1])))
    return (image[start_h:start_h + crop_size[0],
                  start_w:start_w + crop_size[1], ...],
            label[start_h:start_h + crop_size[0],
                  start_w:start_w + crop_size[1], ...])


def random_grayscale(rng: np.random.Generator, image, prob=0.3):
    """Gray with weights [.3, .59, .11] on all three channels when a U(0, 1)
    draw is < prob (list_tag_dataset.py:201-205)."""
    if rng.uniform(0, 1.0) < prob:
        weights = np.array([0.3, 0.59, 0.11], np.float32)
        gray = np.sum(image * weights.reshape(1, 1, 3), axis=-1,
                      keepdims=True)
        return np.tile(gray, (1, 1, 3))
    return image


def random_gaussian_blur(rng: np.random.Generator, image, prob=0.5):
    """5 x 5 kernel exp(-(x^2 + y^2) / sigma^2), sigma ~ U(0.1, 5), each
    channel correlated with mirrored borders (cv2.filter2D's reflect-101),
    when a U(0, 1) draw is < prob (list_tag_dataset.py:208-214)."""
    if rng.uniform(0, 1.0) < prob:
        import scipy.ndimage
        sigma = rng.uniform(0.1, 5)
        wx, wy = np.meshgrid(np.linspace(-2, 2, 5), np.linspace(-2, 2, 5))
        weight = np.exp(-(wx ** 2 + wy ** 2) / sigma ** 2)
        weight = (weight / weight.sum()).astype(np.float32)
        out = np.stack([
            scipy.ndimage.correlate(image[..., c], weight, mode="mirror")
            for c in range(image.shape[-1])], axis=-1)
        return out.astype(np.float32)
    return image
