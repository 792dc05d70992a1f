"""Atrous spatial pyramid head and the bilinear resize.

Port of spml_tpu/models/spp.py (reference: spml/models/heads/spp.py in
twke18/SPML). As an SPML embedding head, ASPP runs without BN or ReLU
(resnet_deeplab.py:37-40): the SUM of four biased 3x3 convs at dilations
6/12/18/24. PSPP is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


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

    def forward(self, x):
        return (self.aspp_1(x) + self.aspp_2(x) + self.aspp_3(x)
                + self.aspp_4(x))
