"""Spatial pyramid heads (ASPP, PSPP) and the bilinear resize.

Port of spml_tpu/models/spp.py (reference: spml/models/heads/spp.py in
twke18/SPML). As an SPML embedding head, ASPP runs without BN or ReLU
(resnet_deeplab.py:37-40): the SUM of four biased 3x3 convs at dilations
6/12/18/24. PSPP (spp.py:46, resnet_pspnet.py:36-40): adaptive average
pools to 1/2/3/6 bins, each a 1x1 conv -> BN -> ReLU resized back,
concatenated with the input and fused by a 3x3 conv -> BN -> ReLU.

Height-sharded (parallel/halo.py; each forward takes its input's global
rows): ASPP exchanges its input's halo once, at dilation 24, and each
branch reads its rows of it. PSPP's adaptive pools reduce over the whole
height: each rank sums its rows of every bin, one sum over the space
group gives every rank the whole pooled maps (halo.adaptive_avg_pools),
on which the 1x1 conv, BN and ReLU run replicated; each map is resized
to the rank's rows of the input's partition from global source
coordinates (halo.resize_whole), and the fusing 3x3 conv exchanges its
halo.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from spml_tpu_torch.models.resnet import BN_EPS, BatchNorm2d
from spml_tpu_torch.parallel import halo

# PSPP's BatchNorms use the reference's momentum whatever
# network.bn_momentum says (the JAX package hard-codes flax 1 - 3e-4)
PSPP_BN_MOMENTUM = 3e-4
PSPP_BINS = (1, 2, 3, 6)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize: torch F.interpolate(bilinear,
    align_corners=False, antialias=False)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def init_torch_conv_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """The JAX package's head initialization: weights uniform with bound
    1/sqrt(fan_in) (torch's default Conv2d init), biases zero."""
    fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
    bound = fan_in ** -0.5
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


class ASPP(nn.Module):
    """Sum of four dilated 3x3 convs with bias (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        for i, d in enumerate((6, 12, 18, 24)):
            setattr(self, f"aspp_{i + 1}", nn.Sequential(nn.Conv2d(
                in_channels, out_channels, 3, padding=d, dilation=d,
                bias=True)))

    def forward(self, x, rows: int | None = None):
        """rows: x's global rows (inside halo.sharded())."""
        return halo.aspp_sum(x, [getattr(self, f"aspp_{i + 1}")[0]
                                 for i in range(4)], rows)


def _conv_bn_relu(cin, cout, kernel):
    return [halo.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False),
            BatchNorm2d(cout, eps=BN_EPS, momentum=PSPP_BN_MOMENTUM),
            nn.ReLU()]


class PSPP(nn.Module):
    """Pyramid pooling (NCHW). Module names are the reference's:
    pspp_{i} = (pool, 1x1 conv, BN, ReLU), conv = (3x3 conv, BN, ReLU);
    the pool's slot is an nn.Identity, since the four pools run
    together before the branches. nn.AdaptiveAvgPool2d's bin i spans
    [floor(i H / s), ceil((i + 1) H / s)), as the JAX package's
    adaptive_avg_pool, also where s > H (overlapping bins). The four
    pools run together (halo.adaptive_avg_pools: one collective when
    height-sharded)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        # slot 0 keeps the reference's state-dict indices (conv 1, BN 2)
        for i in range(len(PSPP_BINS)):
            setattr(self, f"pspp_{i + 1}", nn.Sequential(
                nn.Identity(), *_conv_bn_relu(in_channels, out_channels, 1)))
        self.conv = nn.Sequential(*_conv_bn_relu(
            in_channels + len(PSPP_BINS) * out_channels, out_channels, 3))

    def forward(self, x, rows: int | None = None):
        """rows: x's global rows (inside halo.sharded(); its own rows
        outside one)."""
        rows = x.shape[2] if rows is None else rows
        size = (rows, x.shape[3])
        xs = [x]
        for i, v in enumerate(halo.adaptive_avg_pools(x, PSPP_BINS, rows)):
            v = getattr(self, f"pspp_{i + 1}")(v)
            xs.append(halo.resize_whole(v, size))
        conv, bn, relu = self.conv
        return relu(bn(conv(torch.cat(xs, dim=1), rows)))
