"""Pixel-embedding models (DeepLab / PSPNet heads over ResNet) and the
softmax classifier head.

Port of spml_tpu/models/embeddings.py (reference in twke18/SPML:
spml/models/embeddings/resnet_deeplab.py:16 — backbone -> ASPP (no
bn/relu) -> 2x bilinear upsample -> stride-4 embeddings + location
features; resnet_pspnet.py:36-40 — PSPP(2048 -> 512, BN, ReLU) + 1x1 conv
to the embedding width; resnet_pspnet_densepose.py:38-44 — the same head,
local features with colour, norm_color, smooth_ksize 5;
spml/models/predictions/segsort_softmax.py:22-37 — conv3x3 no bias -> BN
-> ReLU -> Dropout .75 -> conv1x1).

Inputs and outputs are NHWC as in the JAX package; inside, the models run
NCHW on the permuted NHWC tensor, which is channels_last in memory.
Convolutions run in `compute_dtype` (autocast) with float32 parameters;
the embeddings and local features leave the model in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from spml_tpu_torch.models import local
from spml_tpu_torch.models.resnet import (BN_EPS, BN_MOMENTUM,
                                          RESNET_DEPTHS, BatchNorm2d,
                                          ResnetBackbone, init_backbone_)
from spml_tpu_torch.models.spp import (ASPP, PSPP, init_torch_conv_,
                                       resize_bilinear)

PSPP_FEATURE_DIM = 512


def _autocast(x: torch.Tensor, dtype: torch.dtype):
    return torch.autocast(x.device.type, dtype=dtype,
                          enabled=dtype != torch.float32)


class EmbeddingModel(nn.Module):
    """backbone -> ASPP or PSPP head -> x2 upsample -> [B, H/4, W/4, dim]
    embeddings.

    forward(images [B, H, W, 3]) -> (embedding float32, local features
    [B, H/4, W/4, L] float32: L = 2 location channels, 5 with colour).
    resize_as_input (inference): the x2 map is resized again to the
    input's H x W, and the local features are made at that size.
    head "aspp": ASPP(2048 -> dim); "pspp": PSPP(2048 -> 512) then a 1x1
    conv with bias to dim (module `pspp` = (PSPP, conv), the reference's
    names).
    """

    def __init__(self, depth: int = 101, embedding_dim: int = 64,
                 compute_dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM, head: str = "aspp",
                 use_color: bool = False, norm_color: bool = False,
                 smooth_ksize: int | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_color, self.norm_color = use_color, norm_color
        self.smooth_ksize = smooth_ksize
        self.head = head
        self.resnet_backbone = ResnetBackbone(RESNET_DEPTHS[depth],
                                              momentum=bn_momentum)
        if head == "aspp":
            self.aspp = ASPP(2048, embedding_dim)
        elif head == "pspp":
            self.pspp = nn.Sequential(
                PSPP(2048, PSPP_FEATURE_DIM),
                nn.Conv2d(PSPP_FEATURE_DIM, embedding_dim, 1, bias=True))
        else:
            raise ValueError(f"unknown head {head!r}")

    def forward(self, images: torch.Tensor, resize_as_input: bool = False):
        x = images.permute(0, 3, 1, 2)
        with _autocast(x, self.compute_dtype):
            res5 = self.resnet_backbone(x.to(self.compute_dtype))[3]
            emb = getattr(self, self.head)(res5)
        emb = emb.float()
        h, w = emb.shape[2], emb.shape[3]
        emb = F.interpolate(emb, size=(2 * h, 2 * w), mode="bilinear",
                            align_corners=False, antialias=False)
        emb = emb.permute(0, 2, 3, 1)
        if resize_as_input:  # a second resize, not folded into the first
            emb = resize_bilinear(emb, tuple(images.shape[1:3]))
        loc = local.location_color_features(
            images.float(), tuple(emb.shape[1:3]), use_color=self.use_color,
            norm_color=self.norm_color, smooth_ksize=self.smooth_ksize)
        return emb, loc


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout drawing from an explicit generator (flax
    semantics: keep with probability 1 - rate, scale by 1 / (1 - rate))."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class ClassifierHead(nn.Module):
    """conv3x3 (no bias) -> BN -> ReLU -> Dropout -> conv1x1 logits on
    L2-normalized NHWC embeddings; returns float32 NHWC logits."""

    def __init__(self, num_classes: int, hidden_dim: int,
                 embedding_dim: int, dropout_rate: float = 0.75,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.semantic_classifier = nn.Sequential(
            nn.Conv2d(embedding_dim, hidden_dim, 3, padding=1, bias=False),
            # flax momentum 0.9 == torch momentum 0.1
            BatchNorm2d(hidden_dim, eps=BN_EPS, momentum=0.1),
            nn.ReLU(),
            nn.Dropout(dropout_rate),
            nn.Conv2d(hidden_dim, num_classes, 1, bias=True))

    def forward(self, embeddings: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        conv1, bn, relu, drop, conv2 = self.semantic_classifier
        x = embeddings.permute(0, 3, 1, 2)
        with _autocast(x, self.compute_dtype):
            x = relu(bn(conv1(x.to(self.compute_dtype))))
            if self.training:
                x = dropout(x, drop.p, generator)
        # the logits conv runs in float32, as in the JAX package
        x = conv2(x.float())
        return x.permute(0, 2, 3, 1)


_DENSEPOSE = dict(head="pspp", use_color=True, norm_color=True,
                  smooth_ksize=5)
_TABLE = {
    "panoptic_deeplab_101": dict(depth=101),
    "panoptic_deeplab_50": dict(depth=50),
    "panoptic_deeplab_10": dict(depth=10),  # debug/tests
    "panoptic_pspnet_101": dict(depth=101, head="pspp"),
    "panoptic_pspnet_50": dict(depth=50, head="pspp"),
    "panoptic_pspnet_101_densepose": dict(depth=101, **_DENSEPOSE),
    "panoptic_pspnet_10_densepose": dict(depth=10, **_DENSEPOSE),  # tests
}


def build_embedding_model(backbone_types: str, embedding_dim: int,
                          compute_dtype: torch.dtype = torch.float32,
                          bn_momentum: float = BN_MOMENTUM,
                          generator: torch.Generator | None = None
                          ) -> EmbeddingModel:
    """Factory over the reference's network.backbone_types strings
    (spml_tpu/models/embeddings.py:160-174). Weights are drawn on the CPU
    from `generator` (seed 0 when None)."""
    if backbone_types not in _TABLE:
        raise ValueError(f"backbone {backbone_types!r} is not ported")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = EmbeddingModel(embedding_dim=embedding_dim,
                           compute_dtype=compute_dtype,
                           bn_momentum=bn_momentum, **_TABLE[backbone_types])
    init_backbone_(model.resnet_backbone, generator)
    for m in getattr(model, model.head).modules():
        if isinstance(m, nn.Conv2d):
            init_torch_conv_(m, generator)
    return model


def build_classifier_head(num_classes: int, embedding_dim: int,
                          dropout_rate: float = 0.75,
                          compute_dtype: torch.dtype = torch.float32,
                          generator: torch.Generator | None = None
                          ) -> ClassifierHead:
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    head = ClassifierHead(num_classes, embedding_dim * 2, embedding_dim,
                          dropout_rate, compute_dtype)
    for m in head.modules():
        if isinstance(m, nn.Conv2d):
            init_torch_conv_(m, generator)
    return head
