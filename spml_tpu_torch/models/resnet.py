"""ResNet backbone (deeplab-style 3x3x3 stem, dilated), NCHW inside.

Port of spml_tpu/models/resnet.py (reference:
spml/models/backbones/resnet.py in twke18/SPML). Module names are the
reference's torch state-dict names (conv1.conv1.{0,3,6} + conv1.bn1 stem,
res{2..5}.{i}.conv{1,2,3}/bn{1,2,3}/downsample.{0,1}), so a converted
state dict loads with strict=True.

* 3-conv stem (3->64->64->128) stride 2 + maxpool 3x3/2 pad 1;
* stride on the 3x3 conv of each stage's first block;
* the first block of a stage gets reduced dilation (stage dilation 1|2
  -> 1, 4 -> 2), the others the full stage dilation;
* r101 = [3,4,23,3], strides [1,2,1,1], dilations [1,1,2,4]: stride 8.

remat (the JAX package's Stage.remat, flax nn.remat per block): a block
runs under torch.utils.checkpoint, which keeps only its input and runs its
convolutions, BNs and ReLUs again in backward. The recomputation
normalizes with the same batch statistics but leaves the BN buffers as
the forward left them (flax's remat updates them once, too).

Height-sharded (tpu.spatial_partition, parallel/halo.py): inside a
sharded() block every 3x3 convolution (the stem's three, the first at
stride 2, and each block's conv2, at stride 2 in res3.0 and dilations 2
and 4 in res4 / res5), res3.0's 1x1 stride-2 downsample and the stem's
max pool exchange their halo rows, each told its input's global rows
(the backbone's forward carries them from the images' down, and each
stride-2 operation's output rows are those of the partition of its
output's height, so the downsample's rows meet conv2's); the other 1x1
convolutions and the batch norms run on the rank's rows (the batch
norm's statistics over every rank's pixels, each counted once). A remat
block issues its exchanges again in the recomputation, under the
sharding its forward ran with.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from spml_tpu_torch.ops.common import at_least_float32
from spml_tpu_torch.parallel import halo
from spml_tpu_torch.parallel import mesh as mesh_lib

BN_MOMENTUM = 3e-4  # torch convention; flax momentum 1 - 3e-4
BN_EPS = 1e-5

RESNET_DEPTHS = {
    10: (1, 1, 1, 1),  # debug/test-only tiny variant
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


_RECOMPUTE = threading.local()  # .active: inside a block's recomputation


@contextlib.contextmanager
def _recomputing():
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = False


def _remat_contexts():
    """checkpoint's (forward, recompute) contexts: the recompute flags
    itself, so BatchNorm2d does not update its buffers a second time."""
    return contextlib.nullcontext(), _recomputing()


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of every rank
    (parallel/mesh.py).

    Forward: each rank's count, per-channel mean and biased variance
    (float32, or float64 for a float64 x, two passes; a rank with no
    pixels, whose rows of the map are none, sends count 0 and zero
    moments, not var_mean's NaN) are gathered in float64 and combined as
    Chan's parallel variance, sum n_r (var_r + (mean_r - mean)^2) / n, the
    same bits on every rank: the global sum, sum of squares and count
    without the cancellation of sum(x^2) / n - mean^2. Then x is
    normalized with the global mean and biased variance.
    Backward: the all-reduced sum(dy) and sum(dy * x_hat) give dx; the
    weight and bias get this rank's sums alone, since the train step sums
    every parameter gradient over the ranks afterwards.
    Returns (y, global mean, global biased variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = at_least_float32(x)
        if xf.numel():
            var_r, mean_r = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        else:
            var_r = mean_r = xf.new_zeros(xf.shape[1])
        count = torch.full((1,), xf.numel() // xf.shape[1],
                           dtype=torch.float64, device=x.device)
        with mesh_lib.collective("batch norm"):
            every = mesh_lib.all_gather(
                torch.cat([count, mean_r.double(), var_r.double()])[None])
        c = x.shape[1]
        n_r, mean_rs = every[:, :1], every[:, 1:c + 1]
        var_rs = every[:, c + 1:]
        n = n_r.sum()
        mean = (n_r * mean_rs).sum(0) / n
        var = (n_r * (var_rs + (mean_rs - mean) ** 2)).sum(0) / n
        mean, var = mean.to(xf.dtype), var.to(xf.dtype)
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.n = float(n)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        dyf = at_least_float32(dy)
        x_hat = (at_least_float32(x) - mean.view(shape)) * invstd.view(shape)
        sum_dy = dyf.sum((0, 2, 3))
        sum_dy_xhat = (dyf * x_hat).sum((0, 2, 3))
        dx = None
        if ctx.needs_input_grad[0]:
            with mesh_lib.collective("batch norm"):
                glob = mesh_lib.all_reduce(torch.stack([sum_dy,
                                                        sum_dy_xhat]))
            dx = (weight * invstd).view(shape) * (
                dyf - (glob[0] / ctx.n).view(shape)
                - x_hat * (glob[1] / ctx.n).view(shape))
            dx = dx.to(x.dtype)
        return dx, sum_dy_xhat, sum_dy, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's (flax) train-mode statistics.

    Train mode normalizes with the batch statistics and updates the
    running statistics with the BIASED batch variance, as flax does
    (torch's own BatchNorm2d uses the unbiased one). momentum is the
    torch convention: running = (1 - m) * running + m * batch.

    The batch statistics come out of the normalization itself: it runs
    with zeroed scratch running buffers and momentum 1, which leaves the
    batch mean and unbiased variance there, so no second pass reads the
    input. Inside a remat block's recomputation the buffers stay as they
    are.

    In a process group of more than one rank the statistics are those of
    the global batch (_SyncBatchNorm, as XLA computes them over the JAX
    package's sharded batch); a remat recomputation issues its
    collectives again and still leaves the buffers alone.
    """

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        if mesh_lib.world_size() > 1:
            out, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                                  self.eps)
            if not getattr(_RECOMPUTE, "active", False):
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                    self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                    self.num_batches_tracked.add_(1)
            return out
        batch_mean, batch_var = torch.zeros(
            2, self.num_features, dtype=self.running_mean.dtype,
            device=x.device)
        out = F.batch_norm(x, batch_mean, batch_var, self.weight, self.bias,
                           True, 1.0, self.eps)
        if getattr(_RECOMPUTE, "active", False):
            return out
        with torch.no_grad():
            n = x.numel() // x.shape[1]
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(batch_mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(batch_var,
                                                alpha=m * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return out


def conv_bn(cin, cout, kernel, stride=1, dilation=1, momentum=BN_MOMENTUM):
    pad = dilation * (kernel - 1) // 2
    return (halo.Conv2d(cin, cout, kernel, stride, pad, dilation, bias=False),
            BatchNorm2d(cout, eps=BN_EPS, momentum=momentum))


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride, dilation) -> 1x1(x4) with projection shortcut;
    remat: checkpointed where backward reaches the block (the frozen
    stem and res2 run plainly, as does a forward without grad)."""

    def __init__(self, cin, planes, stride=1, dilation=1,
                 has_downsample=False, momentum=BN_MOMENTUM, remat=False):
        super().__init__()
        self.remat = remat
        self.conv1, self.bn1 = conv_bn(cin, planes, 1, momentum=momentum)
        self.conv2, self.bn2 = conv_bn(planes, planes, 3, stride, dilation,
                                       momentum)
        self.conv3, self.bn3 = conv_bn(planes, planes * 4, 1,
                                       momentum=momentum)
        if has_downsample:
            self.downsample = nn.Sequential(
                *conv_bn(cin, planes * 4, 1, stride, momentum=momentum))
        else:
            self.downsample = None

    def _block(self, x, rows):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out, rows)))
        out = self.bn3(self.conv3(out))
        if self.downsample is None:
            residual = x
        else:
            conv, bn = self.downsample
            residual = bn(conv(x, rows))
        return F.relu(out + residual)

    def _block_sharded(self, block, x, rows):
        with halo.sharded(*block):
            return self._block(x, rows)

    def forward(self, x, rows: int | None = None):
        """rows: x's global rows (inside halo.sharded())."""
        if self.remat and torch.is_grad_enabled() and (
                x.requires_grad
                or any(p.requires_grad for p in self.parameters())):
            # no randomness in a block: its RNG state need not be kept;
            # the recomputation runs under the forward's sharding
            return torch.utils.checkpoint.checkpoint(
                self._block_sharded, halo.block(), x, rows,
                use_reentrant=False, context_fn=_remat_contexts,
                preserve_rng_state=False)
        return self._block(x, rows)

    def rows_out(self, rows: int) -> int:
        return self.conv2.rows_out(rows)


class Stem(nn.Module):
    """3x 3x3 conv stem + maxpool (reference resnet.py:66-110)."""

    def __init__(self, momentum=BN_MOMENTUM):
        super().__init__()
        c1, b1 = conv_bn(3, 64, 3, stride=2, momentum=momentum)
        c2, b2 = conv_bn(64, 64, 3, momentum=momentum)
        c3, self.bn1 = conv_bn(64, 128, 3, momentum=momentum)
        self.conv1 = nn.Sequential(c1, b1, nn.ReLU(), c2, b2, nn.ReLU(), c3)

    def forward(self, x, rows: int | None = None):
        """rows: x's global rows (inside halo.sharded(); its own rows
        outside one)."""
        rows = x.shape[2] if rows is None else rows
        c1, b1, r1, c2, b2, r2, c3 = self.conv1
        x = r1(b1(c1(x, rows)))
        rows = c1.rows_out(rows)
        x = r2(b2(c2(x, rows)))
        x = F.relu(self.bn1(c3(x, rows)))
        return halo.max_pool2d(x, 3, 2, 1, rows=rows)

    def rows_out(self, rows: int) -> int:
        return halo.output_rows(self.conv1[0].rows_out(rows), 3, 2, 1, 1)


def make_stage(cin, planes, blocks, stride, dilation, momentum,
               remat=False):
    first_dil = 1 if dilation in (1, 2) else 2
    layers = [Bottleneck(cin, planes, stride, first_dil,
                         has_downsample=(stride != 1 or cin != planes * 4),
                         momentum=momentum, remat=remat)]
    layers += [Bottleneck(planes * 4, planes, 1, dilation, momentum=momentum,
                          remat=remat)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


def stage_remat(remat) -> tuple[bool, bool, bool, bool]:
    """remat as one bool a stage for (res2, res3, res4, res5): a bool for
    all four, or a tuple of four."""
    if isinstance(remat, (tuple, list)):
        if len(remat) != 4:
            raise ValueError(f"remat {remat!r}: one bool for each of "
                             "res2-res5")
        return tuple(bool(r) for r in remat)
    return (bool(remat),) * 4


class ResnetBackbone(nn.Module):
    """NCHW images -> (res2, res3, res4, res5) feature maps. remat: a bool
    or a (res2, res3, res4, res5) tuple of bools (stage_remat)."""

    def __init__(self, blocks, strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
                 momentum=BN_MOMENTUM, remat=False):
        super().__init__()
        self.conv1 = Stem(momentum)
        cin = 128
        for i, (planes, rm) in enumerate(zip((64, 128, 256, 512),
                                             stage_remat(remat))):
            setattr(self, f"res{i + 2}",
                    make_stage(cin, planes, blocks[i], strides[i],
                               dilations[i], momentum, rm))
            cin = planes * 4

    def forward(self, x, rows: int | None = None):
        """rows: the images' global rows (inside halo.sharded(); their
        own rows outside one)."""
        rows = x.shape[2] if rows is None else rows
        x = self.conv1(x, rows)
        rows = self.conv1.rows_out(rows)
        feats = []
        for stage in (self.res2, self.res3, self.res4, self.res5):
            for blk in stage:
                x = blk(x, rows)
                rows = blk.rows_out(rows)
            feats.append(x)
        return tuple(feats)

    def output_rows(self, rows: int) -> int:
        """res5's global rows over images `rows` rows high."""
        rows = self.conv1.rows_out(rows)
        for stage in (self.res2, self.res3, self.res4, self.res5):
            for blk in stage:
                rows = blk.rows_out(rows)
        return rows


def init_backbone_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialization: conv kernels normal(0,
    sqrt(2 / fan_out)) (torch kaiming_normal fan_out), BN scale 1, bias 0,
    running mean 0, var 1."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            with torch.no_grad():
                m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5,
                                 generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
