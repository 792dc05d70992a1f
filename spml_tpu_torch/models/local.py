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
from spml_tpu_torch.parallel import halo, mesh as mesh_lib


def location_features(batch: int, size: tuple[int, int], device=None,
                      rows: range | None = None) -> torch.Tensor:
    """[B, h, w, 2] location features of a grid `size` = (H, W): its
    rows `rows` (all of them when None; a height-sharded rank's rows)."""
    height, w = size
    rows = range(height) if rows is None else rows
    loc = common.generate_location_features(height, w,
                                            device=device) - 0.5
    loc = loc[rows.start:rows.stop]
    return loc[None].expand(batch, len(rows), w, 2)


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


def _whole_images(images: torch.Tensor, mesh) -> torch.Tensor:
    """The whole images of this rank's rows `images` [B, h, W, C] in the
    open halo.sharded() block (its images' global rows): every space
    rank's rows gathered in order over the space group, labelled
    "colour" (no gradient)."""
    with mesh_lib.collective("colour"):
        return mesh_lib.gather_rows(images.contiguous(), mesh, halo.height())


@torch.no_grad()
def location_color_features(images: torch.Tensor, size: tuple[int, int],
                            use_color: bool = False,
                            use_location: bool = True,
                            norm_color: bool = False,
                            smooth_ksize: int | None = None
                            ) -> torch.Tensor:
    """[B, H, W, 3] images -> [B, h, w, L] local features of a grid
    `size` = (h, w), channels [y, x, r, g, b] (location, colour, each
    optional). Inside a halo.sharded() block the images are this rank's
    rows of its images and `size` the grid's global size: the rank gets
    its rows of the grid's partition (location_features). Colour reads
    other ranks' rows (the blur's, the resize's) and per-image
    statistics: the rank's image rows are gathered over the space group
    (_whole_images), the colour features made from the whole images as
    one process makes them, and the rank's rows kept: the same bits.

    Colour, in float32: optionally blurred, bilinearly resized to `size`
    (antialias=False), and with norm_color centred on each image's
    channel mean and divided by the channel's max |.|
    (local_model.py:96-116).
    """
    n = images.shape[0]
    mesh = halo.current()
    rows = halo.own(size[0])
    feats = []
    if use_location:
        feats.append(location_features(n, size, device=images.device,
                                       rows=rows))
    if use_color:
        x = images.float()
        if mesh is not None:
            x = _whole_images(x, mesh)
        if smooth_ksize:
            x = smooth_colors(x, smooth_ksize)
        x = resize_bilinear(x, tuple(size))
        if norm_color:
            c = x.shape[-1]
            x = x - x.reshape(n, -1, c).mean(dim=1)[:, None, None, :]
            mx = x.reshape(n, -1, c).abs().amax(dim=1)
            x = x / mx[:, None, None, :]
        feats.append(x[:, rows.start:rows.stop])
    return torch.cat(feats, dim=-1)
