"""Height-sharded operations: the halo exchange of tpu.spatial_partition.

On the JAX package's ('data', 'space') mesh (spml_tpu/parallel/mesh.py:
28-79) GSPMD shards the image height of every activation over 'space'
and exchanges, around each operation that reads neighbouring rows, the
rows a shard needs from the shards above and below it. Here the S space
ranks of a data rank each hold H / S consecutive rows of every
activation of their images (rank s: rows [s h, (s + 1) h)), and the
row-coupled operations of the embedding network and the classifier head
go through this module while a sharded() block is open: a convolution or
a max pool over rows beyond its own (conv2d, max_pool2d) and the
half-pixel bilinear resize (interpolate). Row-local operations (1x1
convolutions, batch norm, ReLU, the loss) run on the rank's rows as
they are; a 1x1 convolution at stride 2 needs the shard boundary on an
even row.

For an operation (kernel, stride, dilation, padding) whose output rows
split evenly over the ranks, halo_plan gives the rows a rank's output
rows read above and below its own (the same for every rank when its
input rows are stride times its output rows). exchange() fetches them
from whichever ranks own them, also several ranks away (a dilation
larger than a shard), and fills the rows outside the image with the
operation's own padding: zeros for a convolution, -inf for the max pool,
the image's edge row for a half-pixel resize. Its backward returns each
halo row's gradient to its owner, which adds it to its own. The transport
is one all-reduce over the space group of zero-filled buffers in which
each rank fills the rows it owns (mesh.sum_disjoint: exact bits), so
gloo with every rank on one card works; the operation then runs on the
extended rows with no padding along the height.

A tensor read by several operations is exchanged once, at the largest
halo any of them needs (ASPP's four dilations read one res5).

PSPP's adaptive pools read the whole height: adaptive_avg_pools sums
each rank's rows of every bin and adds the sums over the space group
(one collective, labelled "pool"), so that every rank holds the whole
pooled maps; resize_whole resizes such a map to the rank's rows of the
global height from global source coordinates (a row factor that need
not be an integer, unlike interpolate's).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from spml_tpu_torch.parallel import mesh as mesh_lib

FILLS = ("zero", "neg_inf", "edge")
ROW_MULTIPLE = 8  # the network's output stride: crop heights split evenly

_ACTIVE = threading.local()  # .mesh: the layout of the open sharded() block


@contextlib.contextmanager
def sharded(mesh):
    """The forward passes inside take this rank's rows of their images
    (mesh: parallel/mesh.py::Mesh; None or space 1: unsharded)."""
    outer = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = mesh if mesh is not None and mesh.space > 1 else None
    try:
        yield
    finally:
        _ACTIVE.mesh = outer


def current():
    """The mesh of the open sharded() block, None outside one."""
    return getattr(_ACTIVE, "mesh", None)


def check_height(height: int, space: int) -> None:
    """Global image heights split over `space` ranks at every stride of
    the network (2, 4 and 8): a multiple of 8 * space; else ValueError."""
    if space > 1 and height % (ROW_MULTIPLE * space):
        raise ValueError(
            f"image height {height} with tpu.spatial_partition {space}: "
            f"the height must be a multiple of {ROW_MULTIPLE} x "
            f"spatial_partition = {ROW_MULTIPLE * space} (every stride of "
            "the network splits its rows evenly over the space ranks); "
            + mesh_lib.SPATIAL_NEXT)


# ---------------------------------------------------------------------------
# The plan: which rows each rank reads
# ---------------------------------------------------------------------------

def output_rows(height: int, kernel: int, stride: int = 1,
                dilation: int = 1, padding: int = 0) -> int:
    """Rows of the operation's output over an input `height` rows high."""
    return (height + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def halo_plan(kernel: int, stride: int, dilation: int, padding: int,
              rows_in: range, rows_out: range) -> tuple[int, int]:
    """(top, bottom): the rows above rows_in.start and below
    rows_in.stop - 1 that the outputs rows_out of the operation read, in
    global rows (negative: rows of its own that none of them reads)."""
    lo = rows_out.start * stride - padding
    hi = (rows_out.stop - 1) * stride - padding + dilation * (kernel - 1)
    return rows_in.start - lo, hi - (rows_in.stop - 1)


def shard_range(rows: int, space: int, rank: int) -> range:
    if rows % space:
        raise ValueError(f"{rows} rows do not split over {space} ranks")
    h = rows // space
    return range(rank * h, (rank + 1) * h)


def needed_rows(height: int, space: int, kernel: int, stride: int = 1,
                dilation: int = 1, padding: int = 0
                ) -> list[tuple[int, int]]:
    """Each rank's [lo, hi] global input rows (inclusive, beyond the
    image where the padding is) for its share of the output rows."""
    out = output_rows(height, kernel, stride, dilation, padding)
    plans = []
    for s in range(space):
        rin = shard_range(height, space, s)
        top, bottom = halo_plan(kernel, stride, dilation, padding, rin,
                                shard_range(out, space, s))
        plans.append((rin.start - top, rin.stop - 1 + bottom))
    return plans


def row_sources(lo: int, hi: int, height: int, space: int, fill: str
                ) -> list[tuple[int, int]]:
    """(owner rank, its local row) of each global row lo..hi; (-1, -1)
    for a row outside the image filled with a constant; with fill 'edge'
    such a row is the nearest edge row of the image."""
    if fill not in FILLS:
        raise ValueError(f"fill {fill!r}: one of {FILLS}")
    h = height // space
    out = []
    for g in range(lo, hi + 1):
        if fill == "edge":
            g = min(max(g, 0), height - 1)
        out.append(divmod(g, h) if 0 <= g < height else (-1, -1))
    return out


@functools.lru_cache(maxsize=1024)
def _index(values: tuple, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.long, device=device)


def _idx(values, like: torch.Tensor) -> torch.Tensor:
    return _index(tuple(values), str(like.device))


def _remote(sources, rank):
    """The sorted rows a rank reads from other ranks: [(owner, row)]."""
    return sorted({src for src in sources if src[0] not in (rank, -1)})


def assemble(shards, rank: int, lo: int, hi: int, fill: str,
             remote_rows=None) -> torch.Tensor:
    """Rank `rank`'s extended rows lo..hi (dim 2 of NCHW) from its own
    shard shards[rank] and the remote rows `remote_rows` [B, C, R, W] in
    _remote's order; `shards` may hold the other ranks' shards instead
    (the one-process simulation), which are then read directly."""
    x = shards[rank]
    space, h = len(shards), x.shape[2]
    sources = row_sources(lo, hi, h * space, space, fill)
    remote = _remote(sources, rank)
    if remote_rows is None:
        remote_rows = (torch.cat([shards[o][:, :, r:r + 1]
                                  for o, r in remote], dim=2)
                       if remote else x[:, :, :0])
    parts, at = [x, remote_rows], {}
    for j, src in enumerate(remote):
        at[src] = h + j
    const = h + len(remote)
    if any(o < 0 for o, _ in sources):
        value = 0.0 if fill == "zero" else float("-inf")
        parts.append(torch.full_like(x[:, :, :1], value))
    idx = [r if o == rank else (const if o < 0 else at[(o, r)])
           for o, r in sources]
    nhwc = torch.cat([p.permute(0, 2, 3, 1) for p in parts], dim=1)
    ext = nhwc.index_select(1, _idx(idx, x))
    return ext.permute(0, 3, 1, 2)


def _owned(needs, rank):
    """[(slot t, its entries j, this rank's local rows r)] of the remote
    rows of every other rank t that `rank` owns."""
    out = []
    for t, need in enumerate(needs):
        rows = [(j, r) for j, (o, r) in enumerate(need) if o == rank]
        if t != rank and rows:
            out.append((t, *zip(*rows)))
    return out


class _Exchange(torch.autograd.Function):
    """x (this rank's rows, NCHW) -> the remote rows it reads, in
    _remote's order. Forward: every rank fills, in the slot of each other
    rank, the rows of its own that rank reads; one sum over the space
    group. Backward: each rank puts its remote rows' gradient in its own
    slot; one sum; each rank adds the gradient of its rows from every
    slot."""

    @staticmethod
    def forward(ctx, x, mesh, needs):
        s = mesh.space_rank
        ctx.mesh, ctx.needs, ctx.h = mesh, needs, x.shape[2]
        xh = x.permute(0, 2, 3, 1)
        buf = xh.new_zeros((len(needs), xh.shape[0],
                            max(map(len, needs)), *xh.shape[2:]))
        for t, j, r in _owned(needs, s):
            buf[t].index_copy_(1, _idx(j, x), xh.index_select(1, _idx(r, x)))
        with mesh_lib.collective("halo"):
            buf = mesh_lib.sum_disjoint(buf, mesh.space_group())
        return buf[s, :, :len(needs[s])].permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        mesh, needs = ctx.mesh, ctx.needs
        s = mesh.space_rank
        gh = grad.permute(0, 2, 3, 1)
        buf = gh.new_zeros((len(needs), gh.shape[0],
                            max(map(len, needs)), *gh.shape[2:]))
        buf[s, :, :len(needs[s])] = gh
        with mesh_lib.collective("halo"):
            buf = mesh_lib.sum_disjoint(buf, mesh.space_group())
        dx = gh.new_zeros((gh.shape[0], ctx.h, *gh.shape[2:]))
        for t, j, r in _owned(needs, s):
            dx.index_add_(1, _idx(r, grad),
                          buf[t].index_select(1, _idx(j, grad)))
        return dx.permute(0, 3, 1, 2), None, None


def exchange(x: torch.Tensor, mesh, plans, fill: str) -> torch.Tensor:
    """This rank's extended rows plans[space rank] = [lo, hi] (global,
    inclusive) of x, its own rows [B, C, h, W], for the plans of every
    space rank (needed_rows); differentiable."""
    space, h, s = mesh.space, x.shape[2], mesh.space_rank
    needs = [_remote(row_sources(lo, hi, h * space, space, fill), t)
             for t, (lo, hi) in enumerate(plans)]
    # no collective when no rank reads a row of another (every rank
    # computes every rank's needs, so all skip it alike)
    recv = _Exchange.apply(x, mesh, needs) if any(needs) else None
    own = [x if t == s else None for t in range(space)]
    return assemble(own, s, *plans[s], fill, recv)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# The sharded operations
# ---------------------------------------------------------------------------

def conv2d(x: torch.Tensor, weight, bias, stride, padding, dilation,
           groups: int = 1) -> torch.Tensor:
    """F.conv2d over the image whose rows the ranks of the open sharded()
    block hold: this rank's output rows. F.conv2d itself outside one."""
    mesh = current()
    if mesh is None:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    k, st, d, p = weight.shape[2], stride[0], dilation[0], padding[0]
    if k == 1 and p == 0:  # row-local; at stride 2 from an even row
        if x.shape[2] % st:
            raise ValueError(f"a shard of {x.shape[2]} rows under a 1x1 "
                             f"convolution of stride {st}")
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    h = x.shape[2]
    plans = needed_rows(h * mesh.space, mesh.space, k, st, d, p)
    ext = exchange(x, mesh, plans, "zero")
    return F.conv2d(_channels_last(ext), weight, bias, stride,
                    (0, padding[1]), dilation, groups)


def aspp_sum(x: torch.Tensor, convs) -> torch.Tensor:
    """The sum of the stride-1 'same' convs `convs` (ASPP's branches) of
    x, in order; sharded, one exchange at the largest dilation, of which
    each branch reads its own rows."""
    mesh = current()
    out = None
    if mesh is None:
        for c in convs:
            y = c(x)
            out = y if out is None else out + y
        return out
    reach = max(c.padding[0] for c in convs)
    h = x.shape[2]
    plans = needed_rows(h * mesh.space, mesh.space, 3, 1, reach, reach)
    ext = exchange(x, mesh, plans, "zero")
    for c in convs:
        d = c.dilation[0]
        if c.padding[0] != d or c.kernel_size[0] != 3 or c.stride[0] != 1:
            raise ValueError("aspp_sum takes stride-1 'same' 3x3 convs")
        rows = _channels_last(ext[:, :, reach - d:reach + h + d])
        y = F.conv2d(rows, c.weight, c.bias, c.stride, (0, c.padding[1]),
                     c.dilation, c.groups)
        out = y if out is None else out + y
    return out


def max_pool2d(x: torch.Tensor, kernel: int, stride: int,
               padding: int) -> torch.Tensor:
    """F.max_pool2d (square kernel), row-sharded inside sharded()."""
    mesh = current()
    if mesh is None:
        return F.max_pool2d(x, kernel, stride, padding)
    h = x.shape[2]
    plans = needed_rows(h * mesh.space, mesh.space, kernel, stride, 1,
                        padding)
    ext = exchange(x, mesh, plans, "neg_inf")
    return F.max_pool2d(_channels_last(ext), kernel, stride, (0, padding))


def interpolate(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW half-pixel bilinear resize (F.interpolate bilinear,
    align_corners=False, antialias=False) to `size` = (this rank's output
    rows, width). Sharded, the global row factor must be an integer f >=
    1: the rank's output rows read its rows and one above and below, the
    image's edge rows replicated beyond it; the resize of those h + 2
    rows to f (h + 2) rows, rows [f, f + f h), is the global resize's at
    the same source coordinates (the top edge's clamped rows aside, a
    blend of two equal rows, within a rounding of the row)."""
    mesh = current()
    if mesh is None:
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False, antialias=False)
    h, (oh, ow) = x.shape[2], size
    if oh % h:
        raise ValueError(f"a sharded resize of {h} rows to {oh}: the row "
                         "factor must be an integer")
    f = oh // h
    plans = [(t * h - 1, (t + 1) * h) for t in range(mesh.space)]
    ext = exchange(x, mesh, plans, "edge")
    y = F.interpolate(ext, size=(f * (h + 2), ow), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[:, :, f:f + oh]


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """NHWC form of interpolate (models/spp.py::resize_bilinear outside
    sharded())."""
    return interpolate(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose forward is conv2d(): today's nn.Conv2d call
    outside sharded(), the halo-exchanged one inside. Same parameters and
    state-dict names."""

    def forward(self, x):
        if current() is None:
            return super().forward(x)
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups)


# ---------------------------------------------------------------------------
# Whole-height operations: PSPP's pyramid pools
# ---------------------------------------------------------------------------

def adaptive_bins(n: int, s: int) -> list[tuple[int, int]]:
    """nn.AdaptiveAvgPool2d's bins of an axis of n to s: bin i spans
    [floor(i n / s), ceil((i + 1) n / s)), overlapping where s > n."""
    return [((i * n) // s, -(-((i + 1) * n) // s)) for i in range(s)]


def adaptive_avg_pools(x: torch.Tensor, sizes) -> list[torch.Tensor]:
    """F.adaptive_avg_pool2d(x, s) for each s of `sizes` (NCHW), of the
    image whose rows the ranks of the open sharded() block hold: every
    rank gets the whole [B, C, s, s] maps. Each rank sums the columns'
    means of each bin over its own rows of the bin's global rows, in
    float32 at least; one sum over the space group, labelled "pool" (with
    gradient: each rank's rows get the gradient of every rank's use of
    the maps), for every size at once; then each bin's sum over its
    global row count. Outside sharded(), F.adaptive_avg_pool2d."""
    mesh = current()
    if mesh is None:
        return [F.adaptive_avg_pool2d(x, s) for s in sizes]
    b, c, h, _ = x.shape
    height, first = h * mesh.space, mesh.space_rank * h
    xf = x if x.dtype == torch.float64 else x.float()
    parts, counts = [], []
    for s in sizes:
        cols = F.adaptive_avg_pool2d(xf, (h, s))  # [B, C, h, s]
        for lo, hi in adaptive_bins(height, s):
            a, z = max(lo, first) - first, min(hi, first + h) - first
            parts.append(cols[:, :, a:z].sum(2) if z > a
                         else cols.new_zeros((b, c, s)))
            counts += [hi - lo] * s
    sums = torch.cat(parts, dim=2)  # [B, C, sum of s * s]: every bin
    with mesh_lib.collective("pool"):
        sums = mesh_lib.group_sum(sums, mesh.space_group())
    means = (sums / sums.new_tensor(counts)).to(x.dtype)
    return [m.reshape(b, c, s, s) for m, s in zip(
        means.split([s * s for s in sizes], dim=2), sizes)]


def _row_blend(n_in: int, n_out: int, rows: range, dtype):
    """Source rows (i0, i1) and weights (l0, l1) of output rows `rows` of
    a half-pixel bilinear resize of n_in rows to n_out, as F.interpolate
    (align_corners=False) computes them: src = max((r + 0.5) n_in / n_out
    - 0.5, 0), i0 its floor, i1 the next row but at the last, in float32
    (float64 for float64 maps)."""
    acc = np.float64 if dtype == torch.float64 else np.float32
    scale = acc(n_in) / acc(n_out)
    src = np.maximum(scale * (np.arange(rows.start, rows.stop, dtype=acc)
                              + acc(0.5)) - acc(0.5), acc(0))
    i0 = src.astype(np.int64)
    i1 = np.where(i0 < n_in - 1, i0 + 1, i0)
    l1 = src - i0.astype(acc)
    return i0, i1, acc(1) - l1, l1


def resize_whole(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW half-pixel bilinear resize of a map that every rank holds
    whole (PSPP's pooled maps) to `size` = (this rank's output rows,
    width): this rank's rows of the resize to the global height, from
    global source coordinates; the width resized first, in float32 at
    least, then each row blended from its two source rows with
    F.interpolate's weights, the rank's rows alone computed.
    F.interpolate outside sharded()."""
    mesh = current()
    if mesh is None:
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False, antialias=False)
    oh, ow = size
    n_in, n_out = x.shape[2], oh * mesh.space
    xf = x if x.dtype == torch.float64 else x.float()
    xw = F.interpolate(xf, size=(n_in, ow), mode="bilinear",
                       align_corners=False, antialias=False)
    rows = range(mesh.space_rank * oh, (mesh.space_rank + 1) * oh)
    i0, i1, l0, l1 = _row_blend(n_in, n_out, rows, xf.dtype)
    w0 = torch.from_numpy(l0).to(xw.device, xw.dtype).view(1, 1, -1, 1)
    w1 = torch.from_numpy(l1).to(xw.device, xw.dtype).view(1, 1, -1, 1)
    y = (xw.index_select(2, _idx(i0.tolist(), xw)) * w0
         + xw.index_select(2, _idx(i1.tolist(), xw)) * w1)
    return y.to(x.dtype)

