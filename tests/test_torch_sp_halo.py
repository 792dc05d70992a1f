"""The halo exchange of height-sharded training (spml_tpu_torch/parallel/
halo.py) without a process group, on the CPU:

* the partition of a map's rows over the space ranks (balanced blocks,
  equal where the ranks divide the rows);
* the plan (halo_plan, needed_rows) against the rows a brute-force walk
  over each rank's output rows reads, with hypothesis over the height
  (even or not), the space ranks and the operation (kernel, stride,
  dilation, padding);
* a one-process simulation: a float64 tensor cut into the partition's
  row shards, each shard's extended rows assembled from the others
  (halo.assemble, the layout exchange() builds from the transported
  rows) and the sharded operation (halo.conv2d, halo.max_pool2d,
  halo.interpolate, halo.aspp_sum, halo.take_rows) run on them; the rows
  equal the whole operation's at rtol 1e-12 (take_rows exactly). The
  cases take ASPP's dilation 24 over 2-row shards (the tiny network's
  res5), whose halo spans several ranks, the stem's stride 2, the max
  pool's -inf padding and the x2 and x4 half-pixel resizes, whose top
  rows clamp to the image's edge row; and uneven heights over 2, 3 and 4
  ranks: crop 513's maps over 3 (257, 129 and 65 rows), a 1x1 stride-2
  conv whose shard edge falls on an odd row, resizes whose output
  partition is not the input's scaled (65 -> 130 rows over 3: 21/22/22
  -> 43/43/44), also in bf16 against F.interpolate in float32 rounded;
  and maps with fewer rows than ranks, whose partition leaves a rank no
  row (crop 24 over 4: the stride-8 map's 3 rows as none, 1, 1, 1; crop
  16 over 4: 2 rows as none, 1, none, 1; crop 15 and 6 over 3): the
  empty rank's result has no rows, and a rank with output rows but no
  input rows (the x2 upsample of 3 rows over 4: rank 0's output row 0
  from ranks 1 and 2) reads them all from others.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import assume, given, settings, strategies as st

from spml_tpu_torch.parallel import halo
from spml_tpu_torch.parallel import mesh as mesh_lib


def test_partition_rule():
    assert halo.partition(10, 2) == (range(0, 5), range(5, 10))
    assert halo.partition(65, 3) == (range(0, 21), range(21, 43),
                                     range(43, 65))
    assert halo.partition(130, 3) == (range(0, 43), range(43, 86),
                                      range(86, 130))
    assert [len(p) for p in halo.partition(5, 2)] == [2, 3]
    for rows in range(1, 40):
        for space in range(1, 6):
            parts = halo.partition(rows, space)
            assert [r for p in parts for r in p] == list(range(rows))
            sizes = {len(p) for p in parts}
            assert max(sizes) - min(sizes) <= 1
            if rows % space == 0:
                assert sizes == {rows // space}


@settings(max_examples=300, deadline=None)
@given(height=st.integers(1, 48), space=st.integers(1, 4),
       kernel=st.sampled_from([1, 3, 5]), stride=st.integers(1, 2),
       dilation=st.integers(1, 30), pad_share=st.floats(0, 1))
def test_plan_is_the_rows_the_outputs_read(height, space, kernel, stride,
                                           dilation, pad_share):
    padding = int(round(pad_share * dilation * (kernel - 1) / 2))
    out = halo.output_rows(height, kernel, stride, dilation, padding)
    assume(out >= 1)
    plans = halo.needed_rows(height, space, kernel, stride, dilation,
                             padding)
    rows_in = halo.partition(height, space)
    rows_out = halo.partition(out, space)
    for s, (lo, hi) in enumerate(plans):
        read = {o * stride - padding + j * dilation
                for o in rows_out[s] for j in range(kernel)}
        if not read:  # a rank with no output rows reads none
            assert (lo, hi) == (rows_in[s].start, rows_in[s].start - 1)
        else:
            assert (lo, hi) == (min(read), max(read))
        top, bottom = halo.halo_plan(kernel, stride, dilation, padding,
                                     rows_in[s], rows_out[s])
        assert (top, bottom) == (rows_in[s].start - lo,
                                 hi - (rows_in[s].stop - 1))


def test_plan_of_the_network_is_the_same_for_every_rank():
    """stride-1 'same' convs read p rows each side; the stem's stride-2
    conv and the max pool one row above and none below; uneven, a
    stride-2 conv of 129 rows over 3 ranks (43 each) reads for each rank
    its rows of the 65 output rows' partition (21/22/22), the last one
    the padding row below the image; 6 output rows over 8 ranks leave
    ranks 0 and 4 none, which read no row (hi = lo - 1)."""
    assert halo.needed_rows(64, 2, 3, 1, 24, 24) == [(-24, 55), (8, 87)]
    assert halo.needed_rows(16, 2, 3, 2, 1, 1) == [(-1, 7), (7, 15)]
    assert halo.needed_rows(129, 3, 3, 2, 1, 1) == [(-1, 41), (41, 85),
                                                    (85, 129)]
    assert halo.needed_rows(12, 8, 3, 2, 1, 1) == [  # 6 output rows over 8
        (0, -1), (-1, 1), (1, 3), (3, 5), (6, 5), (5, 7), (7, 9), (9, 11)]
    assert halo.needed_rows(3, 4, 3, 1, 4, 4) == [(0, -1), (-4, 4), (-3, 5),
                                                  (-2, 6)]


def _shards(x, space):
    return [x[:, :, p.start:p.stop]
            for p in halo.partition(x.shape[2], space)]


@contextlib.contextmanager
def _simulated(shards, calls=None):
    """halo.exchange in one process: the remote rows read from the other
    shards directly (no process group); each call appended to `calls`."""
    orig = halo.exchange

    def exchange(x, mesh, plans, height, fill):
        if calls is not None:
            calls.append(fill)
        lo, hi = plans[mesh.space_rank]
        local = list(shards)
        local[mesh.space_rank] = x
        return halo.assemble(local, mesh.space_rank, lo, hi, fill, height)

    halo.exchange = exchange
    try:
        yield
    finally:
        halo.exchange = orig


def _sharded_rows(x, space, op, calls=None):
    """op(this rank's rows, x's global rows) on each rank's shard of x
    inside sharded(), the rows joined."""
    shards = _shards(x, space)
    out = []
    with _simulated(shards, calls):
        for s in range(space):
            with halo.sharded(mesh_lib.Mesh(s, space, space)):
                out.append(op(shards[s], x.shape[2]))
    return torch.cat(out, dim=2)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


CONVS = [  # (height, space, kernel, stride, dilation, padding)
    (4, 2, 3, 1, 24, 24),  # ASPP's largest dilation on 2-row shards
    (8, 2, 3, 1, 4, 4),  # res5's conv2
    (8, 4, 3, 1, 2, 2),  # res4's conv2, 2-row shards
    (32, 2, 3, 2, 1, 1),  # the stem's first conv
    (16, 2, 3, 1, 1, 1),
    (8, 2, 1, 2, 1, 0),  # the 1x1 stride-2 downsample, no halo
    (513, 3, 3, 2, 1, 1),  # crop 513's stem conv: 171 rows -> 86/85/86
    (129, 3, 1, 2, 1, 0),  # res3.0's downsample at crop 513: odd edges
    (129, 3, 3, 2, 1, 1),  # and its conv2, on the same output rows
    (65, 3, 3, 1, 24, 24),  # ASPP's dilation 24 over 21/22/22 rows
    (5, 2, 3, 1, 4, 4),  # crop 40's res5 over 2 ranks: 2/3 rows
    (11, 4, 1, 2, 1, 0),  # a shard edge on an odd row over 4 ranks
    (10, 4, 3, 1, 2, 2),
    # fewer rows than ranks: a rank with no rows of the input or output
    (3, 4, 3, 1, 4, 4),  # crop 24's res5 over 4: none, 1, 1, 1 rows
    (3, 4, 3, 1, 24, 24),  # and ASPP's dilation 24 on it
    (2, 4, 3, 1, 2, 2),  # crop 16's res4 over 4: none, 1, none, 1
    (6, 4, 3, 2, 1, 1),  # crop 24's res3.0 conv2: 6 rows -> 3 over 4
    (6, 4, 1, 2, 1, 0),  # and its downsample
    (3, 4, 1, 1, 1, 0),  # a 1x1 conv at stride 1 (row-local) on none
    (2, 3, 3, 1, 4, 4),  # crop 15's res5 over 3: none, 1, 1
    (4, 3, 3, 2, 1, 1),  # crop 15's res3.0 conv2: 4 rows -> 2 over 3
    (1, 3, 3, 1, 24, 24),  # crop 6's res5 over 3: none, none, 1
]


@pytest.mark.parametrize("height,space,kernel,stride,dilation,padding",
                         CONVS)
def test_sharded_conv_equals_the_whole_conv(height, space, kernel, stride,
                                            dilation, padding):
    g = torch.Generator().manual_seed(height * 31 + dilation)
    x = torch.randn(2, 3, height, 7, generator=g, dtype=torch.float64)
    w = torch.randn(5, 3, kernel, kernel, generator=g, dtype=torch.float64)
    b = torch.randn(5, generator=g, dtype=torch.float64)
    want = F.conv2d(x, w, b, stride, padding, dilation)
    got = _sharded_rows(x, space, lambda xs, rows: halo.conv2d(
        xs, w, b, (stride, stride), (padding, padding),
        (dilation, dilation), rows=rows))
    _close(got, want)


def test_sharded_aspp_sum_is_one_exchange():
    """The four ASPP branches over 2-row shards from one exchange."""
    g = torch.Generator().manual_seed(5)
    convs = [torch.nn.Conv2d(4, 3, 3, padding=d, dilation=d).double()
             for d in (6, 12, 18, 24)]
    for c in convs:
        with torch.no_grad():
            c.bias.normal_(generator=g)
    x = torch.randn(2, 4, 4, 5, generator=g, dtype=torch.float64)
    calls = []
    with torch.no_grad():
        want = convs[0](x) + convs[1](x) + convs[2](x) + convs[3](x)
        got = _sharded_rows(x, 2, lambda xs, rows: halo.aspp_sum(
            xs, convs, rows), calls)
    assert calls == ["zero", "zero"]  # one a rank
    _close(got, want)


@pytest.mark.parametrize("height,space", [(16, 2), (32, 4), (257, 3),
                                          (21, 4), (4, 4), (3, 4), (2, 3)])
def test_sharded_max_pool_equals_the_whole_pool(height, space):
    g = torch.Generator().manual_seed(height)
    x = -torch.rand(2, 3, height, 9, generator=g, dtype=torch.float64)
    want = F.max_pool2d(x, 3, 2, 1)
    got = _sharded_rows(x, space, lambda xs, rows: halo.max_pool2d(
        xs, 3, 2, 1, rows=rows))
    _close(got, want)


@pytest.mark.parametrize("height,space,out", [
    (4, 2, 8), (8, 2, 32), (8, 4, 16), (2, 2, 8),
    (65, 3, 130),  # crop 513's x2 upsample: 21/22/22 -> 43/43/44 rows
    (130, 3, 513),  # and its logits to the image: 43/43/44 -> 171 each
    (5, 2, 10), (10, 2, 40),  # crop 40's over 2: 2/3 -> 5/5, 5/5 -> 20
    (7, 4, 14), (14, 4, 56), (9, 3, 13),
    # fewer input rows than ranks; ranks with output rows and no input
    (3, 4, 6),  # crop 24's x2 upsample: rank 0's row from ranks 1, 2
    (2, 4, 4),  # crop 16's: none, 1, none, 1 -> 1, 1, 1, 1
    (1, 4, 2),  # crop 8's: only rank 3 holds the row
    (2, 4, 8),  # crop 8's logits to the image: ranks 0, 2 hold no input
    (2, 3, 4), (4, 3, 15),  # crop 15's upsample and logits over 3
    (1, 3, 2)])  # crop 6's upsample
def test_sharded_resize_equals_the_whole_resize(height, space, out):
    """The x2 upsample of the embeddings and the resize of the logits
    to the image: the edge rows of the image, not of the shard, clamp,
    and each rank's output rows are the output's partition's."""
    g = torch.Generator().manual_seed(height * out)
    x = torch.randn(2, 3, height, 5, generator=g, dtype=torch.float64)
    size = (out, 5 * 2)
    want = F.interpolate(x, size=size, mode="bilinear",
                         align_corners=False, antialias=False)
    got = _sharded_rows(x, space, lambda xs, rows: halo.interpolate(
        xs, size, rows))
    _close(got, want)
    nhwc = _sharded_rows(x, space, lambda xs, rows: halo.resize_bilinear(
        xs.permute(0, 2, 3, 1), size, rows).permute(0, 3, 1, 2))
    _close(nhwc, want)


@pytest.mark.parametrize("height,space,out", [(65, 3, 130), (5, 2, 10),
                                              (3, 4, 6)])
def test_sharded_bf16_resize_is_the_whole_resize_rounded(height, space,
                                                         out):
    """bf16 maps: each row blended in float32 and rounded once, as
    F.interpolate of the whole map in float32 and rounded to bf16, within
    one bf16 rounding of the float32 blend's order."""
    g = torch.Generator().manual_seed(height)
    x = torch.randn(2, 3, height, 5, generator=g).to(torch.bfloat16)
    want = F.interpolate(x.float(), size=(out, 10), mode="bilinear",
                         align_corners=False).to(torch.bfloat16)
    got = _sharded_rows(x, space, lambda xs, rows: halo.interpolate(
        xs, (out, 10), rows))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("height,space,out", [
    (513, 3, 130),  # crop 513's labels: a rank reads another's rows
    (40, 2, 10), (20, 4, 7), (64, 2, 16),
    (8, 4, 2), (6, 3, 2)])  # crops 8 and 6: ranks with no output row
def test_sharded_take_rows_is_the_whole_labels_resize(height, space, out):
    from spml_tpu_torch.ops import common

    labels = torch.from_numpy(np.random.RandomState(height).randint(
        0, 200, (2, height, 11)))
    whole = common.resize_labels(labels, (out, 6))
    got = _sharded_rows(labels[:, None], space, lambda xs, rows:
                        common.resize_labels(xs[:, 0], (out, 6),
                                             rows)[:, None])
    assert torch.equal(got[:, 0], whole)


def test_outside_a_sharded_block_the_ops_are_torch_s():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 2, 6, 6, generator=g)
    conv = halo.Conv2d(2, 3, 3, padding=2, dilation=2)
    assert halo.current() is None
    assert torch.equal(conv(x), F.conv2d(x, conv.weight, conv.bias, 1, 2, 2))
    assert torch.equal(halo.max_pool2d(x, 3, 2, 1),
                       F.max_pool2d(x, 3, 2, 1))
    assert torch.equal(halo.interpolate(x, (12, 12)), F.interpolate(
        x, size=(12, 12), mode="bilinear", align_corners=False))
    with halo.sharded(mesh_lib.Mesh(0, 2, 1)):  # space 1: unsharded
        assert halo.current() is None


def test_crop_height_rule():
    """Any crop height that the space ranks divide builds (JAX's
    device_put requires as much), also one whose deeper maps leave a rank
    no row (24 and 16 over 4: the stride-8 map's 3 and 2 rows; 15 over 3;
    8 over 4: the embeddings' 2 rows); another raises."""
    for height, space in ((32, 2), (36, 1), (40, 2), (513, 3), (30, 3),
                          (36, 4), (24, 4), (16, 4), (15, 3), (8, 4)):
        halo.check_height(height, space)
    with pytest.raises(ValueError, match="multiple of spatial_partition"):
        halo.check_height(40, 3)
