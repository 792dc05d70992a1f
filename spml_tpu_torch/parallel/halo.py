"""Height-sharded operations: the halo exchange of tpu.spatial_partition.

On the JAX package's ('data', 'space') mesh (spml_tpu/parallel/mesh.py:
28-79) GSPMD shards the image height of every activation over 'space'
and exchanges, around each operation that reads neighbouring rows, the
rows a shard needs from the shards above and below it; where a height
does not split evenly it pads, and the padded rows enter no result (the
sharded step equals the one-device step). Here the S space ranks of a
data rank each hold, of every map R rows high, the rows partition(R, S)
gives them: rank s rows [floor(s R / S), floor((s + 1) R / S)), equal
blocks whenever S divides R, and no padding anywhere. The images and
labels are cut so (H / S rows each; a height that S does not divide
raises, as JAX's device_put does); every map below them has its own
partition, and no rank's rows of one map are those of another scaled.

The row-coupled operations of the embedding network and the classifier
head go through this module while a sharded() block is open: a
convolution or a max pool over rows beyond its own (conv2d, max_pool2d,
also a 1x1 convolution at stride 2, whose output rows need not start on
the rank's own rows) and the half-pixel bilinear resize (interpolate).
Each takes its input's global height (`rows`), which no operation infers
from its own rows, computes this rank's output rows from the partition
of its output's height, and the input rows they read. Row-local
operations (1x1 convolutions at stride 1, batch norm, ReLU, the loss)
run on the rank's rows as they are.

halo_plan gives the rows a rank's output rows read above and below its
own input rows. exchange() fetches them from whichever ranks own them,
also several ranks away (a dilation larger than a shard), and fills the
rows outside the image with the operation's own padding: zeros for a
convolution, -inf for the max pool. Its backward returns each halo row's
gradient to its owner, which adds it to its own. The transport is one
all-reduce over the space group of zero-filled buffers in which each rank
fills the rows it owns (mesh.sum_disjoint: exact bits, any dtype), so
gloo with every rank on one card works; the operation then runs on the
extended rows with no padding along the height.

A tensor read by several operations is exchanged once, at the largest
halo any of them needs (ASPP's four dilations read one res5).

PSPP's adaptive pools read the whole height: adaptive_avg_pools sums
each rank's rows of every bin and adds the sums over the space group
(one collective, labelled "pool"), so that every rank holds the whole
pooled maps. The bilinear resizes blend each of the rank's output rows
from its two source rows at global coordinates, with F.interpolate's
weights (_blend): resize_whole from a map every rank holds whole,
interpolate from the source rows the rank fetched.

A map may have fewer rows than there are space ranks (the deeper maps of
a short crop: crop 24 over 4 leaves the stride-8 map's 3 rows as none,
1, 1, 1): a rank's share of it is then empty. Such a rank still enters
every exchange and every sum over the space group, in the same order as
the others, and its empty rows stay in the autograd graph, so that its
backward enters the same collectives; an operation that refuses a map
with no rows (F.conv2d, F.max_pool2d, F.interpolate,
F.adaptive_avg_pool2d) runs instead on rows of zeros appended to it,
and its rows are dropped (_on_rows): the result has no rows and its
gradient reaches the input's. Only the images themselves must give
every rank a row: their height is a multiple of the space ranks
(check_height).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import threading

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from spml_tpu_torch.parallel import mesh as mesh_lib

FILLS = ("zero", "neg_inf", "edge")

_ACTIVE = threading.local()  # .block: (mesh, image rows) of sharded()


@contextlib.contextmanager
def sharded(mesh, height: int | None = None):
    """The forward passes inside take this rank's rows of their images,
    `height` rows high in all (mesh: parallel/mesh.py::Mesh; None or
    space 1: unsharded, and height unused)."""
    outer = getattr(_ACTIVE, "block", None)
    if mesh is not None and mesh.space > 1:
        if height is not None:
            check_height(height, mesh.space)
        _ACTIVE.block = (mesh, height)
    else:
        _ACTIVE.block = None
    try:
        yield
    finally:
        _ACTIVE.block = outer


def current():
    """The mesh of the open sharded() block, None outside one."""
    block = getattr(_ACTIVE, "block", None)
    return None if block is None else block[0]


def block():
    """(mesh, image rows) of the open sharded() block, (None, None)
    outside one: sharded(*block()) opens it again (a remat block's
    recomputation)."""
    return getattr(_ACTIVE, "block", None) or (None, None)


def height() -> int:
    """The images' global rows of the open sharded() block."""
    mesh, rows = block()
    if mesh is None or rows is None:
        raise ValueError("the images' height is that of a sharded() block "
                         "opened with it")
    return rows


def check_height(height: int, space: int) -> None:
    """A crop height splits over `space` ranks: a multiple of space (the
    images' cut, as the JAX package's device_put requires); else
    ValueError. The maps below the images may leave a rank no row."""
    if space > 1 and height % space:
        raise ValueError(
            f"image height {height} with tpu.spatial_partition {space}: "
            "the height must be a multiple of spatial_partition (each "
            "space rank holds height / spatial_partition image rows)")


# ---------------------------------------------------------------------------
# The partition and the plan: which rows each rank holds and reads
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def partition(rows: int, space: int) -> tuple[range, ...]:
    """Each space rank's rows of a map `rows` high: rank s holds [floor(s
    rows / space), floor((s + 1) rows / space)), equal blocks when space
    divides rows, and none for some ranks when rows < space (3 over 4:
    none, [0, 1), [1, 2), [2, 3))."""
    return tuple(range(s * rows // space, (s + 1) * rows // space)
                 for s in range(space))


def own(rows: int) -> range:
    """This rank's rows of a map `rows` high in the open sharded() block;
    all of them outside one."""
    mesh = current()
    if mesh is None:
        return range(rows)
    return partition(rows, mesh.space)[mesh.space_rank]


def share(mesh, rows, held: int) -> range:
    """This space rank's rows of a map `rows` high, which it holds `held`
    of: ValueError when rows is missing or held is not its share."""
    if rows is None:
        raise ValueError("a sharded map's global rows are needed (rows=)")
    mine = partition(rows, mesh.space)[mesh.space_rank]
    if held != len(mine):
        raise ValueError(f"{held} rows on space rank {mesh.space_rank}, its "
                         f"share of {rows} rows is {len(mine)}")
    return mine


def output_rows(height: int, kernel: int, stride: int = 1,
                dilation: int = 1, padding: int = 0) -> int:
    """Rows of the operation's output over an input `height` rows high."""
    return (height + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def halo_plan(kernel: int, stride: int, dilation: int, padding: int,
              rows_in: range, rows_out: range) -> tuple[int, int]:
    """(top, bottom): the rows above rows_in.start and below
    rows_in.stop - 1 that the outputs rows_out of the operation read, in
    global rows (negative: rows of its own that none of them reads).
    Empty rows_out read nothing: (0, -len(rows_in)), the empty range
    rows_in.start .. rows_in.start - 1."""
    if not rows_out:
        return 0, -len(rows_in)
    lo = rows_out.start * stride - padding
    hi = (rows_out.stop - 1) * stride - padding + dilation * (kernel - 1)
    return rows_in.start - lo, hi - (rows_in.stop - 1)


def needed_rows(height: int, space: int, kernel: int, stride: int = 1,
                dilation: int = 1, padding: int = 0
                ) -> list[tuple[int, int]]:
    """Each rank's [lo, hi] global input rows (inclusive, beyond the
    image where the padding is) for its rows of the output's partition,
    its own input rows those of the input's; hi = lo - 1 (no row) for a
    rank with no output row."""
    out = output_rows(height, kernel, stride, dilation, padding)
    parts_in, parts_out = partition(height, space), partition(out, space)
    plans = []
    for rin, rout in zip(parts_in, parts_out):
        top, bottom = halo_plan(kernel, stride, dilation, padding, rin, rout)
        plans.append((rin.start - top, rin.stop - 1 + bottom))
    return plans


def row_sources(lo: int, hi: int, height: int, space: int, fill: str
                ) -> list[tuple[int, int]]:
    """(owner rank, its local row) of each global row lo..hi of a map
    `height` rows high under partition(height, space) (none when hi <
    lo); (-1, -1) for a row outside the image filled with a constant;
    with fill 'edge' such a row is the nearest edge row of the image. The
    owner is the last rank whose rows start at or before the row: a rank
    with no rows starts where the next one does."""
    if fill not in FILLS:
        raise ValueError(f"fill {fill!r}: one of {FILLS}")
    parts = partition(height, space)
    starts = [p.start for p in parts]
    out = []
    for g in range(lo, hi + 1):
        if fill == "edge":
            g = min(max(g, 0), height - 1)
        if 0 <= g < height:
            owner = bisect.bisect_right(starts, g) - 1
            out.append((owner, g - starts[owner]))
        else:
            out.append((-1, -1))
    return out


@functools.lru_cache(maxsize=1024)
def _index(values: tuple, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.long, device=device)


def _idx(values, like: torch.Tensor) -> torch.Tensor:
    return _index(tuple(values), str(like.device))


def _remote(sources, rank):
    """The sorted rows a rank reads from other ranks: [(owner, row)]."""
    return sorted({src for src in sources if src[0] not in (rank, -1)})


def assemble(shards, rank: int, lo: int, hi: int, fill: str, height: int,
             remote_rows=None) -> torch.Tensor:
    """Rank `rank`'s extended rows lo..hi (dim 2 of NCHW) of a map
    `height` rows high from its own shard shards[rank] and the remote
    rows `remote_rows` [B, C, R, W] in _remote's order; `shards` may hold
    the other ranks' shards instead (the one-process simulation), which
    are then read directly. No rows (hi < lo): a [B, C, 0, W] result
    that keeps x and remote_rows in the graph."""
    x = shards[rank]
    b, c, h, w = x.shape
    sources = row_sources(lo, hi, height, len(shards), fill)
    if (remote_rows is None and sources
            and all(o == rank for o, _ in sources)
            and sources[-1][1] - sources[0][1] == len(sources) - 1):
        # its own consecutive rows, no exchange: a view (the rows an
        # exchange returns stay in the graph on every rank, so that every
        # rank runs its backward's collective)
        return x[:, :, sources[0][1]:sources[-1][1] + 1]
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
        parts.append(x.new_full((b, c, 1, w), value))
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


def exchange(x: torch.Tensor, mesh, plans, height: int,
             fill: str) -> torch.Tensor:
    """This rank's extended rows plans[space rank] = [lo, hi] (global,
    inclusive) of x, its own rows [B, C, h, W] of a map `height` rows
    high, for the plans of every space rank; differentiable."""
    space, s = mesh.space, mesh.space_rank
    needs = [_remote(row_sources(lo, hi, height, space, fill), t)
             for t, (lo, hi) in enumerate(plans)]
    # no collective when no rank reads a row of another (every rank
    # computes every rank's needs, so all skip it alike)
    recv = _Exchange.apply(x, mesh, needs) if any(needs) else None
    shards = [x if t == s else None for t in range(space)]
    return assemble(shards, s, *plans[s], fill, height, recv)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def _on_rows(op, x: torch.Tensor, reach: int) -> torch.Tensor:
    """op(x), op a row operation one of whose output rows reads `reach`
    rows of x [B, C, h, W] (no padding along the height). A rank with no
    output rows holds no rows of x: op then runs on `reach` rows of zeros
    appended to x, and its one output row is dropped, so the [B, C', 0,
    W'] result stays in the autograd graph (its backward reaches x's)
    without op taking a map of no rows, which torch refuses."""
    if x.shape[2]:
        return op(x)
    b, c, _, w = x.shape
    return op(torch.cat([x, x.new_zeros((b, c, reach, w))], dim=2))[:, :, :0]


# ---------------------------------------------------------------------------
# The sharded operations
# ---------------------------------------------------------------------------

def conv2d(x: torch.Tensor, weight, bias, stride, padding, dilation,
           groups: int = 1, rows: int | None = None) -> torch.Tensor:
    """F.conv2d over the image whose rows the ranks of the open sharded()
    block hold, `rows` rows high: this rank's rows of the output's
    partition. F.conv2d itself outside one (rows unused), and for a 1x1
    convolution at stride 1 (row-local)."""
    mesh = current()
    k, st, d, p = weight.shape[2], stride[0], dilation[0], padding[0]
    if mesh is None:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    if k == 1 and st == 1 and p == 0:
        return _on_rows(lambda t: F.conv2d(t, weight, bias, stride, padding,
                                           dilation, groups), x, 1)
    share(mesh, rows, x.shape[2])
    plans = needed_rows(rows, mesh.space, k, st, d, p)
    ext = exchange(x, mesh, plans, rows, "zero")
    return _on_rows(lambda t: F.conv2d(
        _channels_last(t), weight, bias, stride, (0, padding[1]), dilation,
        groups), ext, d * (k - 1) + 1)


def aspp_sum(x: torch.Tensor, convs, rows: int | None = None
             ) -> torch.Tensor:
    """The sum of the stride-1 'same' convs `convs` (ASPP's branches) of
    x, in order; sharded (x's global rows `rows`), one exchange at the
    largest dilation, of which each branch reads its own rows."""
    mesh = current()
    out = None
    if mesh is None:
        for c in convs:
            y = c(x)
            out = y if out is None else out + y
        return out
    share(mesh, rows, x.shape[2])
    reach = max(c.padding[0] for c in convs)
    h = x.shape[2]
    plans = needed_rows(rows, mesh.space, 3, 1, reach, reach)
    ext = exchange(x, mesh, plans, rows, "zero")
    for c in convs:
        d = c.dilation[0]
        if c.padding[0] != d or c.kernel_size[0] != 3 or c.stride[0] != 1:
            raise ValueError("aspp_sum takes stride-1 'same' 3x3 convs")
        part = ext[:, :, reach - d:reach + h + d]
        y = _on_rows(lambda t, c=c: F.conv2d(
            _channels_last(t), c.weight, c.bias, c.stride,
            (0, c.padding[1]), c.dilation, c.groups), part, 2 * d + 1)
        out = y if out is None else out + y
    return out


def max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int,
               rows: int | None = None) -> torch.Tensor:
    """F.max_pool2d (square kernel), row-sharded inside sharded() (x's
    global rows `rows`)."""
    mesh = current()
    if mesh is None:
        return F.max_pool2d(x, kernel, stride, padding)
    share(mesh, rows, x.shape[2])
    plans = needed_rows(rows, mesh.space, kernel, stride, 1, padding)
    ext = exchange(x, mesh, plans, rows, "neg_inf")
    return _on_rows(lambda t: F.max_pool2d(_channels_last(t), kernel, stride,
                                           (0, padding)), ext, kernel)


@functools.lru_cache(maxsize=1024)
def _row_blend(n_in: int, n_out: int, start: int, stop: int, wide: bool):
    """Source rows (i0, i1) and weights (l0, l1) of output rows
    [start, stop) of a half-pixel bilinear resize of n_in rows to n_out,
    as F.interpolate (align_corners=False) computes them: src = max((r +
    0.5) n_in / n_out - 0.5, 0), i0 its floor, i1 the next row but at the
    last, in float32 (float64 when wide)."""
    acc = np.float64 if wide else np.float32
    scale = acc(n_in) / acc(n_out)
    src = np.maximum(scale * (np.arange(start, stop, dtype=acc)
                              + acc(0.5)) - acc(0.5), acc(0))
    i0 = src.astype(np.int64)
    i1 = np.where(i0 < n_in - 1, i0 + 1, i0)
    l1 = src - i0.astype(acc)
    out = i0, i1, acc(1) - l1, l1
    for a in out:  # cached: every caller reads the same arrays
        a.setflags(write=False)
    return out


def _blend(x: torch.Tensor, first: int, n_in: int, n_out: int,
           rows: range, width: int) -> torch.Tensor:
    """Rows `rows` of the half-pixel bilinear resize of a map n_in rows
    high to (n_out, width), from x [B, C, R, W]: its global rows first ..
    first + R - 1, which hold every source row of `rows` (none when
    `rows` is empty). The width resized first, in float32 at least, then
    each row blended from its two source rows with F.interpolate's
    weights."""
    xf = x if x.dtype == torch.float64 else x.float()
    xw = _on_rows(lambda t: F.interpolate(
        t, size=(t.shape[2], width), mode="bilinear", align_corners=False,
        antialias=False), xf, 1)
    i0, i1, l0, l1 = _row_blend(n_in, n_out, rows.start, rows.stop,
                                xf.dtype == torch.float64)
    w0 = torch.tensor(l0, dtype=xw.dtype, device=xw.device).view(1, 1, -1, 1)
    w1 = torch.tensor(l1, dtype=xw.dtype, device=xw.device).view(1, 1, -1, 1)
    y = (xw.index_select(2, _idx((i0 - first).tolist(), xw)) * w0
         + xw.index_select(2, _idx((i1 - first).tolist(), xw)) * w1)
    return y.to(x.dtype)


def interpolate(x: torch.Tensor, size, rows: int | None = None
                ) -> torch.Tensor:
    """NCHW half-pixel bilinear resize (F.interpolate bilinear,
    align_corners=False, antialias=False) to `size` = (global rows,
    width). Sharded (x's global rows `rows`): this rank's rows of the
    output's partition, each blended from its two source rows at global
    coordinates (_blend), the source rows fetched from the ranks that
    own them."""
    mesh = current()
    if mesh is None:
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False, antialias=False)
    share(mesh, rows, x.shape[2])
    n_out, width = size
    parts = partition(n_out, mesh.space)
    wide = x.dtype == torch.float64
    plans = []
    for p in parts:  # a rank with no output rows reads none
        i0, i1, _, _ = _row_blend(rows, n_out, p.start, p.stop, wide)
        plans.append((int(i0[0]), int(i1[-1])) if p else (0, -1))
    ext = exchange(x, mesh, plans, rows, "edge")
    return _blend(ext, plans[mesh.space_rank][0], rows, n_out,
                  parts[mesh.space_rank], width)


def resize_bilinear(x: torch.Tensor, size, rows: int | None = None
                    ) -> torch.Tensor:
    """NHWC form of interpolate (models/spp.py::resize_bilinear outside
    sharded())."""
    return interpolate(x.permute(0, 3, 1, 2), size, rows).permute(0, 2, 3, 1)


def take_rows(x: torch.Tensor, rows: int, index) -> torch.Tensor:
    """x [B, C, h, W] (this rank's rows of a map `rows` high inside the
    open sharded() block; the whole map outside one) at the global rows
    index[r] of this rank's rows r of the partition of len(index) rows
    (index non-decreasing, every entry in the map), fetched from the
    ranks that own them: exact, any dtype (the labels' nearest resize)."""
    mesh = current()
    if mesh is None:
        return x.index_select(2, _idx(list(index), x))
    share(mesh, rows, x.shape[2])
    parts = partition(len(index), mesh.space)
    plans = [(index[p.start], index[p.stop - 1]) if p else (0, -1)
             for p in parts]
    ext = exchange(x, mesh, plans, rows, "edge")
    lo, mine = plans[mesh.space_rank][0], parts[mesh.space_rank]
    return ext.index_select(2, _idx([index[r] - lo for r in mine], ext))


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose forward is conv2d(): today's nn.Conv2d call
    outside sharded(), the halo-exchanged one inside (rows: x's global
    rows). Same parameters and state-dict names."""

    def forward(self, x, rows: int | None = None):
        if current() is None:
            return super().forward(x)
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups, rows)

    def rows_out(self, rows: int) -> int:
        """The output's global rows over an input `rows` rows high."""
        return output_rows(rows, self.kernel_size[0], self.stride[0],
                           self.dilation[0], self.padding[0])


# ---------------------------------------------------------------------------
# Whole-height operations: PSPP's pyramid pools
# ---------------------------------------------------------------------------

def adaptive_bins(n: int, s: int) -> list[tuple[int, int]]:
    """nn.AdaptiveAvgPool2d's bins of an axis of n to s: bin i spans
    [floor(i n / s), ceil((i + 1) n / s)), overlapping where s > n."""
    return [((i * n) // s, -(-((i + 1) * n) // s)) for i in range(s)]


def adaptive_avg_pools(x: torch.Tensor, sizes, rows: int | None = None
                       ) -> list[torch.Tensor]:
    """F.adaptive_avg_pool2d(x, s) for each s of `sizes` (NCHW), of the
    image whose rows the ranks of the open sharded() block hold, `rows`
    rows high: every rank gets the whole [B, C, s, s] maps. Each rank
    sums the columns' means of each bin over its own rows of the bin's
    global rows, in float32 at least; one sum over the space group,
    labelled "pool" (with gradient: each rank's rows get the gradient of
    every rank's use of the maps), for every size at once; then each
    bin's sum over its global row count. Outside sharded(),
    F.adaptive_avg_pool2d."""
    mesh = current()
    if mesh is None:
        return [F.adaptive_avg_pool2d(x, s) for s in sizes]
    share(mesh, rows, x.shape[2])
    b, c, h, _ = x.shape
    first = partition(rows, mesh.space)[mesh.space_rank].start
    xf = x if x.dtype == torch.float64 else x.float()
    parts, counts = [], []
    for s in sizes:
        cols = _on_rows(lambda t, s=s: F.adaptive_avg_pool2d(
            t, (t.shape[2], s)), xf, 1)  # [B, C, h, s]
        for lo, hi in adaptive_bins(rows, s):
            # a bin without rows of this rank: the sum of none of them,
            # zeros in the graph (a rank with no rows still enters the
            # sum's backward)
            a, z = max(lo, first) - first, min(hi, first + h) - first
            parts.append(cols[:, :, a:max(a, z)].sum(2))
            counts += [hi - lo] * s
    sums = torch.cat(parts, dim=2)  # [B, C, sum of s * s]: every bin
    with mesh_lib.collective("pool"):
        sums = mesh_lib.group_sum(sums, mesh.space_group())
    means = (sums / sums.new_tensor(counts)).to(x.dtype)
    return [m.reshape(b, c, s, s) for m, s in zip(
        means.split([s * s for s in sizes], dim=2), sizes)]


def resize_whole(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW half-pixel bilinear resize of a map that every rank holds
    whole (PSPP's pooled maps) to `size` = (global rows, width): this
    rank's rows of the output's partition, from global source
    coordinates (_blend), the rank's rows alone computed. F.interpolate
    outside sharded()."""
    mesh = current()
    if mesh is None:
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False, antialias=False)
    n_out, width = size
    return _blend(x, 0, x.shape[2], n_out, own(n_out), width)
