"""Location and colour features of the pixel embeddings.

Port of spml_tpu/models/local.py (reference:
spml/models/embeddings/local_model.py in twke18/SPML — GaussianConv2d:13,
LocationColorNetwork:38): the normalized (y, x) grid shifted to
[-0.5, 0.5], and for the DensePose variant the image colours, blurred,
resized to the embedding grid and normalized per image. Nothing here is
trained, so these are plain functions, all without gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spml_tpu_torch.models.spp import resize_bilinear
from spml_tpu_torch.ops import common


def location_features(batch: int, size: tuple[int, int], device=None,
                      shard: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """[B, h, w, 2] location features. shard (rank, ranks): rows [rank h,
    (rank + 1) h) of the grid of an image ranks x h rows high (its
    height-sharded rows)."""
    h, w = size
    rank, ranks = shard
    loc = common.generate_location_features(h * ranks, w,
                                            device=device) - 0.5
    loc = loc[rank * h:(rank + 1) * h]
    return loc[None].expand(batch, h, w, 2)


def gaussian_kernel(ksize: int) -> torch.Tensor:
    """The reference's (unusual) odd kernel: sqrt(dy^2 + dx^2) over its
    own sum, so the centre weighs 0 (local_model.py:25-27)."""
    w = (torch.arange(ksize, dtype=torch.float32) - ksize // 2) ** 2
    w = torch.sqrt(w[None, :] + w[:, None])
    return w / w.sum()


@torch.no_grad()
def smooth_colors(images: torch.Tensor, ksize: int) -> torch.Tensor:
    """Depthwise blur of NHWC images by gaussian_kernel, VALID padding
    (torch's conv default): the output is (H - ksize + 1, W - ksize + 1)."""
    x = images.permute(0, 3, 1, 2)
    c = x.shape[1]
    k = gaussian_kernel(ksize).to(x.device, x.dtype)
    out = F.conv2d(x, k.expand(c, 1, ksize, ksize), groups=c)
    return out.permute(0, 2, 3, 1)


@torch.no_grad()
def location_color_features(images: torch.Tensor, size: tuple[int, int],
                            use_color: bool = False,
                            use_location: bool = True,
                            norm_color: bool = False,
                            smooth_ksize: int | None = None,
                            shard: tuple[int, int] = (0, 1)
                            ) -> torch.Tensor:
    """[B, H, W, 3] images -> [B, h, w, L] local features, channels
    [y, x, r, g, b] (location, colour, each optional). shard: the
    location grid's rows of a height-sharded image (location_features);
    colour (per-image statistics) is not sharded.

    Colour, in float32: optionally blurred, bilinearly resized to `size`
    (antialias=False), and with norm_color centred on each image's
    channel mean and divided by the channel's max |.|
    (local_model.py:96-116).
    """
    n = images.shape[0]
    feats = []
    if use_location:
        feats.append(location_features(n, size, device=images.device,
                                       shard=shard))
    if use_color:
        if shard[1] > 1:
            raise NotImplementedError("colour features of a height-sharded "
                                      "image")
        x = images.float()
        if smooth_ksize:
            x = smooth_colors(x, smooth_ksize)
        x = resize_bilinear(x, size)
        if norm_color:
            c = x.shape[-1]
            x = x - x.reshape(n, -1, c).mean(dim=1)[:, None, None, :]
            mx = x.reshape(n, -1, c).abs().amax(dim=1)
            x = x / mx[:, None, None, :]
        feats.append(x)
    return torch.cat(feats, dim=-1)
