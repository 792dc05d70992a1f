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
the embeddings and local features leave the model in float32 (the
embeddings of a float64 model, compute_dtype float64, in float64: the
tests' exact reference).

Height-sharded (tpu.spatial_partition, inside parallel/halo.py's
sharded(), opened with the images' global height): the images are this
rank's rows of its images, and the outputs its rows of the partition of
the embeddings' global height (embedding_rows), which need not be the
images' rows scaled. The backbone, ASPP, PSPP's fusing conv and the
classifier head's 3x3 conv exchange halo rows, each told its input's
global rows; PSPP's pools are summed over the space group
(models/spp.py); the x2 upsample blends the rank's output rows from the
source rows it fetched (halo.interpolate); the location features are the
global grid's rows, the colour features the rank's rows of the whole
images' (made from the gathered images, models/local.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from spml_tpu_torch.models import local
from spml_tpu_torch.models.resnet import (BN_EPS, BN_MOMENTUM,
                                          RESNET_DEPTHS, BatchNorm2d,
                                          ResnetBackbone, init_backbone_)
from spml_tpu_torch.models.spp import (ASPP, PSPP, init_torch_conv_,
                                       resize_bilinear)
from spml_tpu_torch.ops.common import at_least_float32
from spml_tpu_torch.parallel import halo

PSPP_FEATURE_DIM = 512


def _autocast(x: torch.Tensor, dtype: torch.dtype):
    return torch.autocast(x.device.type, dtype=dtype,
                          enabled=dtype in (torch.bfloat16, torch.float16))


class EmbeddingModel(nn.Module):
    """backbone -> ASPP or PSPP head -> x2 upsample -> [B, H/4, W/4, dim]
    embeddings.

    forward(images [B, H, W, 3]) -> (embedding float32, local features
    [B, H/4, W/4, L] float32: L = 2 location channels, 5 with colour).
    resize_as_input (inference): the x2 map is resized again to the
    input's H x W, and the local features are made at that size.
    head "aspp": ASPP(2048 -> dim); "pspp": PSPP(2048 -> 512) then a 1x1
    conv with bias to dim (module `pspp` = (PSPP, conv), the reference's
    names). remat: the backbone's (models/resnet.py::stage_remat).
    """

    def __init__(self, depth: int = 101, embedding_dim: int = 64,
                 compute_dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM, head: str = "aspp",
                 use_color: bool = False, norm_color: bool = False,
                 smooth_ksize: int | None = None, remat=False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_color, self.norm_color = use_color, norm_color
        self.smooth_ksize = smooth_ksize
        self.head = head
        self.resnet_backbone = ResnetBackbone(RESNET_DEPTHS[depth],
                                              momentum=bn_momentum,
                                              remat=remat)
        if head == "aspp":
            self.aspp = ASPP(2048, embedding_dim)
        elif head == "pspp":
            self.pspp = nn.Sequential(
                PSPP(2048, PSPP_FEATURE_DIM),
                halo.Conv2d(PSPP_FEATURE_DIM, embedding_dim, 1, bias=True))
        else:
            raise ValueError(f"unknown head {head!r}")

    def forward(self, images: torch.Tensor, resize_as_input: bool = False):
        rows = images.shape[1]
        if halo.current() is not None:
            if resize_as_input:
                raise NotImplementedError("resize_as_input (inference) "
                                          "runs unsharded")
            rows = halo.height()
            halo.share(halo.current(), rows, images.shape[1])
        x = images.permute(0, 3, 1, 2)
        r5 = self.resnet_backbone.output_rows(rows)
        with _autocast(x, self.compute_dtype):
            res5 = self.resnet_backbone(x.to(self.compute_dtype), rows)[3]
            if self.head == "aspp":
                emb = self.aspp(res5, r5)
            else:
                pspp, conv = self.pspp
                emb = conv(pspp(res5, r5))
        emb = at_least_float32(emb)
        size = (2 * r5, 2 * emb.shape[3])
        emb = halo.interpolate(emb, size, r5)
        emb = emb.permute(0, 2, 3, 1)
        if resize_as_input:  # a second resize, not folded into the first
            emb = resize_bilinear(emb, tuple(images.shape[1:3]))
            size = tuple(emb.shape[1:3])
        loc = local.location_color_features(
            images.float(), size, use_color=self.use_color,
            norm_color=self.norm_color, smooth_ksize=self.smooth_ksize)
        return emb, loc

    def embedding_rows(self, height: int) -> int:
        """The embeddings' global rows over images `height` rows high
        (without resize_as_input)."""
        return 2 * self.resnet_backbone.output_rows(height)


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
    L2-normalized NHWC embeddings; returns float32 NHWC logits. The 3x3
    conv exchanges halo rows inside halo.sharded() (forward's rows: the
    embeddings' global rows)."""

    def __init__(self, num_classes: int, hidden_dim: int,
                 embedding_dim: int, dropout_rate: float = 0.75,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.semantic_classifier = nn.Sequential(
            halo.Conv2d(embedding_dim, hidden_dim, 3, padding=1,
                        bias=False),
            # flax momentum 0.9 == torch momentum 0.1
            BatchNorm2d(hidden_dim, eps=BN_EPS, momentum=0.1),
            nn.ReLU(),
            nn.Dropout(dropout_rate),
            halo.Conv2d(hidden_dim, num_classes, 1, bias=True))

    def forward(self, embeddings: torch.Tensor,
                generator: torch.Generator | None = None,
                rows: int | None = None) -> torch.Tensor:
        """rows: the embeddings' global rows (inside halo.sharded())."""
        conv1, bn, relu, drop, conv2 = self.semantic_classifier
        x = embeddings.permute(0, 3, 1, 2)
        with _autocast(x, self.compute_dtype):
            x = relu(bn(conv1(x.to(self.compute_dtype), rows)))
            if self.training:
                x = dropout(x, drop.p, generator)
        # the logits conv runs in float32, as in the JAX package (float64
        # stays float64)
        x = conv2(at_least_float32(x))
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
                          generator: torch.Generator | None = None,
                          remat=False) -> EmbeddingModel:
    """Factory over the reference's network.backbone_types strings
    (spml_tpu/models/embeddings.py:160-174). Weights are drawn on the CPU
    from `generator` (seed 0 when None); remat: the backbone's
    activation checkpointing (models/resnet.py::stage_remat)."""
    if backbone_types not in _TABLE:
        raise ValueError(f"backbone {backbone_types!r} is not ported")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = EmbeddingModel(embedding_dim=embedding_dim,
                           compute_dtype=compute_dtype,
                           bn_momentum=bn_momentum, remat=remat,
                           **_TABLE[backbone_types])
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
