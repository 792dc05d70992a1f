"""Plain PyTorch forward of SPML's embedding networks and classifier head.

Written from the published architecture (twke18/SPML:
spml/models/backbones/resnet.py, spml/models/embeddings/resnet_deeplab.py,
resnet_pspnet.py, resnet_pspnet_densepose.py, local_model.py,
spml/models/heads/spp.py, spml/models/predictions/segsort_softmax.py),
as functions over a dict of named tensors whose names are the reference's
torch state-dict names. Imports nothing of the program.

* ResNet: 3-conv stem (3->64->64->128, the first at stride 2) + max pool
  3/2 pad 1; bottlenecks 1x1 -> 3x3 (stride, dilation) -> 1x1 (x4) with a
  projection shortcut on each stage's first block; strides (1, 2, 1, 1),
  dilations (1, 1, 2, 4), the first block of a stage at dilation 1 where
  the stage's is 1 or 2, else 2: output stride 8.
* DeepLab head: the sum of four biased 3x3 convs at dilations 6, 12, 18,
  24 (no BN, no ReLU). PSPNet head: adaptive average pools to 1, 2, 3, 6
  bins, each 1x1 conv -> BN -> ReLU resized back, concatenated with the
  input, 3x3 conv -> BN -> ReLU, then a biased 1x1 conv to the embedding
  width.
* Embeddings: the head's output resized x2 (bilinear, half-pixel) in
  float32; inference resizes that again to the input's size.
* Classifier head: 3x3 conv (no bias) -> BN -> ReLU -> dropout -> 1x1
  conv with bias, on the L2-normalized embeddings.

Precision: the configuration's compute dtype (bf16) for every conv of
the backbone, the heads and the classifier's 3x3 conv, with float32
parameters rounded to it; batch norm statistics in float32; bilinear
resizes, and the concatenation PSPNet feeds its fusing conv, in the type
automatic mixed precision gives a resize on the device (float32 on the
card: there a resize's backward summing a pooled map's thousands of
gradients in bf16 would lose a tenth of them); the
classifier's logits conv in float32. `lower="fp8"` rounds each such
conv's operands to float8 e4m3 (per-tensor scale) first: the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
DEPTHS = {101: (3, 4, 23, 3), 50: (3, 4, 6, 3), 10: (1, 1, 1, 1)}
PSPP_BINS = (1, 2, 3, 6)
PSPP_DIM = 512
ASPP_DILATIONS = (6, 12, 18, 24)

_RESIZE_DTYPE = {}  # (device type, compute type) -> autocast's resize type
ARCHS = {  # network.backbone_types -> (depth, head, colour features)
    "panoptic_deeplab_101": (101, "aspp", False),
    "panoptic_deeplab_10": (10, "aspp", False),
    "panoptic_pspnet_101_densepose": (101, "pspp", True),
    "panoptic_pspnet_10_densepose": (10, "pspp", True),
}


# ---------------------------------------------------------------------------
# Parameter names and shapes
# ---------------------------------------------------------------------------

def _bn(spec, name, c):
    spec += [(f"{name}.weight", (c,), "one"), (f"{name}.bias", (c,), "zero"),
             (f"{name}.running_mean", (c,), "zero"),
             (f"{name}.running_var", (c,), "one"),
             (f"{name}.num_batches_tracked", (), "count")]


def _conv(spec, name, cin, cout, k, kind="he", bias=False):
    spec.append((f"{name}.weight", (cout, cin, k, k), kind))
    if bias:
        spec.append((f"{name}.bias", (cout,), "zero"))


def blocks(depth):
    """[(stage, index, cin, planes, stride, dilation, downsample)] of the
    backbone's bottlenecks."""
    out, cin = [], 128
    for s, (n, planes, stride, dil) in enumerate(zip(
            DEPTHS[depth], (64, 128, 256, 512), (1, 2, 1, 1), (1, 1, 2, 4))):
        for i in range(n):
            first = i == 0
            d = (1 if dil in (1, 2) else 2) if first else dil
            out.append((s + 2, i, cin if first else planes * 4, planes,
                        stride if first else 1, d,
                        first and (stride != 1 or cin != planes * 4)))
        cin = planes * 4
    return out


def embedding_spec(backbone_types: str, dim: int):
    """[(name, shape, init)] of the embedding model's state dict."""
    depth, head, _ = ARCHS[backbone_types]
    spec = []
    stem = "resnet_backbone.conv1.conv1"
    _conv(spec, f"{stem}.0", 3, 64, 3)
    _bn(spec, f"{stem}.1", 64)
    _conv(spec, f"{stem}.3", 64, 64, 3)
    _bn(spec, f"{stem}.4", 64)
    _conv(spec, f"{stem}.6", 64, 128, 3)
    _bn(spec, "resnet_backbone.conv1.bn1", 128)
    for stage, i, cin, planes, _, _, down in blocks(depth):
        p = f"resnet_backbone.res{stage}.{i}"
        _conv(spec, f"{p}.conv1", cin, planes, 1)
        _bn(spec, f"{p}.bn1", planes)
        _conv(spec, f"{p}.conv2", planes, planes, 3)
        _bn(spec, f"{p}.bn2", planes)
        _conv(spec, f"{p}.conv3", planes, planes * 4, 1)
        _bn(spec, f"{p}.bn3", planes * 4)
        if down:
            _conv(spec, f"{p}.downsample.0", cin, planes * 4, 1)
            _bn(spec, f"{p}.downsample.1", planes * 4)
    if head == "aspp":
        for i in range(4):
            _conv(spec, f"aspp.aspp_{i + 1}.0", 2048, dim, 3, "head", True)
    else:
        for i in range(4):
            _conv(spec, f"pspp.0.pspp_{i + 1}.1", 2048, PSPP_DIM, 1, "head")
            _bn(spec, f"pspp.0.pspp_{i + 1}.2", PSPP_DIM)
        _conv(spec, "pspp.0.conv.0", 2048 + 4 * PSPP_DIM, PSPP_DIM, 3, "head")
        _bn(spec, "pspp.0.conv.1", PSPP_DIM)
        _conv(spec, "pspp.1", PSPP_DIM, dim, 1, "head", True)
    return spec


def classifier_spec(num_classes: int, dim: int):
    """[(name, shape, init)] of the classifier head's state dict."""
    spec = []
    _conv(spec, "semantic_classifier.0", dim, 2 * dim, 3, "head")
    _bn(spec, "semantic_classifier.1", 2 * dim)
    _conv(spec, "semantic_classifier.4", 2 * dim, num_classes, 1, "head",
          True)
    return spec


def make_weights(spec, generator: torch.Generator, device) -> dict:
    """The state dict of `spec` from `generator`, in three calls on the
    device: one normal draw for every conv kernel, split and scaled (the
    backbone's by sqrt(2 / fan_out), He; the heads' by sqrt(1 / (3
    fan_in)), the spread of torch's default uniform init); BN scales 1,
    biases and means 0, variances 1."""
    sizes = [int(torch.Size(s).numel()) for _, s, k in spec
             if k in ("he", "head")]
    draw = torch.randn(sum(sizes), generator=generator, device=device)
    parts = iter(draw.split(sizes))
    out = {}
    for name, shape, kind in spec:
        if kind in ("he", "head"):
            cout, cin, kh, kw = shape
            std = ((2.0 / (cout * kh * kw)) if kind == "he"
                   else 1.0 / (3.0 * cin * kh * kw)) ** 0.5
            out[name] = (next(parts) * std).view(shape)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale (amax -> 448)."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    q = (t.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()  # gradients pass straight


class Net:
    """The forward of one configuration over a state dict `w`."""

    def __init__(self, w: dict, backbone_types: str, dtype=torch.bfloat16,
                 train: bool = True, lower: str | None = None):
        self.w, self.dtype, self.train, self.lower = w, dtype, train, lower
        self.depth, self.head, self.colour = ARCHS[backbone_types]

    def conv(self, x, name, stride=1, padding=0, dilation=1):
        wt = self.w[f"{name}.weight"].to(self.dtype)
        b = self.w.get(f"{name}.bias")
        x = x.to(self.dtype)
        if self.lower == "fp8":
            x, wt = _fp8(x), _fp8(wt)
        x = x.contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, wt, None if b is None else b.to(self.dtype),
                        stride, padding, dilation)

    def resize_dtype(self, x):
        """The type automatic mixed precision resizes x's type in on x's
        device: what a bilinear resize under torch.autocast returns
        there (float32 on the card)."""
        key = (x.device.type, self.dtype)
        if key not in _RESIZE_DTYPE:
            with torch.autocast(x.device.type, dtype=self.dtype):
                probe = F.interpolate(
                    torch.zeros(1, 1, 2, 2, dtype=self.dtype,
                                device=x.device), size=(4, 4),
                    mode="bilinear", align_corners=False)
            _RESIZE_DTYPE[key] = probe.dtype
        return _RESIZE_DTYPE[key]

    def bn(self, x, name):
        w = self.w
        if self.train:
            return F.batch_norm(x, None, None, w[f"{name}.weight"],
                                w[f"{name}.bias"], True, 0.0, BN_EPS)
        return F.batch_norm(x, w[f"{name}.running_mean"],
                            w[f"{name}.running_var"], w[f"{name}.weight"],
                            w[f"{name}.bias"], False, 0.0, BN_EPS)

    def backbone(self, x):
        s = "resnet_backbone.conv1.conv1"
        x = F.relu(self.bn(self.conv(x, f"{s}.0", 2, 1), f"{s}.1"))
        x = F.relu(self.bn(self.conv(x, f"{s}.3", 1, 1), f"{s}.4"))
        x = F.relu(self.bn(self.conv(x, f"{s}.6", 1, 1),
                           "resnet_backbone.conv1.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage, i, _, _, stride, d, down in blocks(self.depth):
            p = f"resnet_backbone.res{stage}.{i}"
            out = F.relu(self.bn(self.conv(x, f"{p}.conv1"), f"{p}.bn1"))
            out = F.relu(self.bn(self.conv(out, f"{p}.conv2", stride, d, d),
                                 f"{p}.bn2"))
            out = self.bn(self.conv(out, f"{p}.conv3"), f"{p}.bn3")
            res = x if not down else self.bn(
                self.conv(x, f"{p}.downsample.0", stride),
                f"{p}.downsample.1")
            x = F.relu(out + res)
        return x

    def head_out(self, r5):
        if self.head == "aspp":
            out = None
            for i, d in enumerate(ASPP_DILATIONS):
                y = self.conv(r5, f"aspp.aspp_{i + 1}.0", 1, d, d)
                out = y if out is None else out + y
            return out
        size = r5.shape[2:]
        wide = self.resize_dtype(r5)
        xs = [r5.to(wide)]
        for i, s in enumerate(PSPP_BINS):
            v = F.adaptive_avg_pool2d(r5, s)
            p = f"pspp.0.pspp_{i + 1}"
            v = F.relu(self.bn(self.conv(v, f"{p}.1"), f"{p}.2"))
            xs.append(F.interpolate(v.to(wide), size=tuple(size),
                                    mode="bilinear", align_corners=False))
        x = F.relu(self.bn(self.conv(torch.cat(xs, 1), "pspp.0.conv.0", 1, 1),
                           "pspp.0.conv.1"))
        return self.conv(x, "pspp.1")

    def embeddings(self, images, resize_as_input=False):
        """images [B, H, W, 3] -> float32 embeddings [B, h, w, D] (h = H/4,
        or H with resize_as_input)."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        e = self.head_out(self.backbone(x)).float()
        e = F.interpolate(e, size=(2 * e.shape[2], 2 * e.shape[3]),
                          mode="bilinear", align_corners=False)
        if resize_as_input:
            e = F.interpolate(e, size=tuple(images.shape[1:3]),
                              mode="bilinear", align_corners=False)
        return e.permute(0, 2, 3, 1)

    def classifier(self, emb, generator=None, rate=0.75):
        """Logits [B, h, w, C] (float32) of L2-normalized embeddings; in
        training, inverted dropout with keep masks drawn from `generator`
        as torch.rand(shape) >= rate."""
        x = emb.permute(0, 3, 1, 2)
        s = "semantic_classifier"
        x = F.relu(self.bn(self.conv(x, f"{s}.0", 1, 1), f"{s}.1"))
        if self.train:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) >= rate
            x = torch.where(keep, x / (1.0 - rate), 0.0)
        x = F.conv2d(x.float(), self.w[f"{s}.4.weight"],
                     self.w[f"{s}.4.bias"])
        return x.permute(0, 2, 3, 1)


def location(h: int, w: int, device) -> torch.Tensor:
    """[h, w, 2] (y, x) grid, each from 0 to 1 in even steps, minus 0.5."""
    y = torch.linspace(0.0, 1.0, h, device=device)
    x = torch.linspace(0.0, 1.0, w, device=device)
    return torch.stack([y[:, None].expand(h, w), x[None, :].expand(h, w)],
                       -1) - 0.5


def colour(images: torch.Tensor, size, ksize: int = 5) -> torch.Tensor:
    """DensePose's colour features [B, h, w, 3]: each channel blurred by
    the kernel sqrt(dy^2 + dx^2) / its sum (valid padding), resized
    bilinearly to `size`, minus its image mean, over its image's max
    |value| (local_model.py:25-27, 96-116)."""
    r = (torch.arange(ksize, dtype=torch.float32,
                      device=images.device) - ksize // 2) ** 2
    k = torch.sqrt(r[None, :] + r[:, None])
    k = k / k.sum()
    x = images.float().permute(0, 3, 1, 2)
    x = F.conv2d(x, k.expand(3, 1, ksize, ksize), groups=3)
    x = F.interpolate(x, size=tuple(size), mode="bilinear",
                      align_corners=False).permute(0, 2, 3, 1)
    b = x.shape[0]
    x = x - x.reshape(b, -1, 3).mean(1)[:, None, None, :]
    return x / x.reshape(b, -1, 3).abs().amax(1)[:, None, None, :]
