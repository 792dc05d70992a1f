"""The halo exchange of height-sharded training (spml_tpu_torch/parallel/
halo.py) without a process group, on the CPU:

* the plan (halo_plan, needed_rows) against the rows a brute-force walk
  over each rank's output rows reads, with hypothesis over the height,
  the space ranks and the operation (kernel, stride, dilation, padding);
* a one-process simulation: a float64 tensor cut into row shards, each
  shard's extended rows assembled from the others (halo.assemble, the
  layout exchange() builds from the transported rows) and the sharded
  operation (halo.conv2d, halo.max_pool2d, halo.interpolate, halo.aspp_sum)
  run on them; the rows equal the whole operation's at rtol 1e-12. The
  cases take ASPP's dilation 24 over 2-row shards (the tiny network's
  res5), whose halo spans several ranks, the stem's stride 2, the max
  pool's -inf padding and the x2 and x4 half-pixel resizes, whose top
  rows clamp to the image's edge row.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import assume, given, settings, strategies as st

from spml_tpu_torch.parallel import halo
from spml_tpu_torch.parallel import mesh as mesh_lib


@settings(max_examples=300, deadline=None)
@given(h=st.integers(1, 12), space=st.integers(1, 4),
       kernel=st.sampled_from([1, 3, 5]), stride=st.integers(1, 2),
       dilation=st.integers(1, 30), pad_share=st.floats(0, 1))
def test_plan_is_the_rows_the_outputs_read(h, space, kernel, stride,
                                           dilation, pad_share):
    height = h * space
    padding = int(round(pad_share * dilation * (kernel - 1) / 2))
    out = halo.output_rows(height, kernel, stride, dilation, padding)
    assume(out > 0 and out % space == 0)
    plans = halo.needed_rows(height, space, kernel, stride, dilation,
                             padding)
    for s, (lo, hi) in enumerate(plans):
        read = {o * stride - padding + j * dilation
                for o in halo.shard_range(out, space, s)
                for j in range(kernel)}
        assert (lo, hi) == (min(read), max(read))
        top, bottom = halo.halo_plan(kernel, stride, dilation, padding,
                                     halo.shard_range(height, space, s),
                                     halo.shard_range(out, space, s))
        assert (top, bottom) == (s * h - lo, hi - ((s + 1) * h - 1))


def test_plan_of_the_network_is_the_same_for_every_rank():
    """stride-1 'same' convs read p rows each side; the stem's stride-2
    conv and the max pool one row above and none below."""
    assert halo.needed_rows(64, 2, 3, 1, 24, 24) == [(-24, 55), (8, 87)]
    assert halo.needed_rows(16, 2, 3, 2, 1, 1) == [(-1, 7), (7, 15)]
    with pytest.raises(ValueError, match="split"):
        halo.needed_rows(12, 8, 3, 1, 1, 1)


def _shards(x, space):
    return list(torch.chunk(x, space, dim=2))


@contextlib.contextmanager
def _simulated(shards, calls=None):
    """halo.exchange in one process: the remote rows read from the other
    shards directly (no process group); each call appended to `calls`."""
    orig = halo.exchange

    def exchange(x, mesh, plans, fill):
        if calls is not None:
            calls.append(fill)
        lo, hi = plans[mesh.space_rank]
        local = list(shards)
        local[mesh.space_rank] = x
        return halo.assemble(local, mesh.space_rank, lo, hi, fill)

    halo.exchange = exchange
    try:
        yield
    finally:
        halo.exchange = orig


def _sharded_rows(x, space, op, calls=None):
    """op on each rank's shard of x inside sharded(), the rows joined."""
    shards = _shards(x, space)
    out = []
    with _simulated(shards, calls):
        for s in range(space):
            with halo.sharded(mesh_lib.Mesh(s, space, space)):
                out.append(op(shards[s]))
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
    got = _sharded_rows(x, space, lambda xs: halo.conv2d(
        xs, w, b, (stride, stride), (padding, padding),
        (dilation, dilation)))
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
        got = _sharded_rows(x, 2, lambda xs: halo.aspp_sum(xs, convs),
                            calls)
    assert calls == ["zero", "zero"]  # one a rank
    _close(got, want)


@pytest.mark.parametrize("height,space", [(16, 2), (32, 4)])
def test_sharded_max_pool_equals_the_whole_pool(height, space):
    g = torch.Generator().manual_seed(height)
    x = -torch.rand(2, 3, height, 9, generator=g, dtype=torch.float64)
    want = F.max_pool2d(x, 3, 2, 1)
    got = _sharded_rows(x, space, lambda xs: halo.max_pool2d(xs, 3, 2, 1))
    _close(got, want)


@pytest.mark.parametrize("height,space,factor",
                         [(4, 2, 2), (8, 2, 4), (8, 4, 2), (2, 2, 4)])
def test_sharded_resize_equals_the_whole_resize(height, space, factor):
    """The x2 upsample of the embeddings and the x4 resize of the logits
    to the image: the edge rows of the image, not of the shard, clamp."""
    g = torch.Generator().manual_seed(height * factor)
    x = torch.randn(2, 3, height, 5, generator=g, dtype=torch.float64)
    size = (height * factor, 5 * factor)
    want = F.interpolate(x, size=size, mode="bilinear",
                         align_corners=False, antialias=False)
    got = _sharded_rows(x, space, lambda xs: halo.interpolate(
        xs, (xs.shape[2] * factor, size[1])))
    _close(got, want)
    nhwc = _sharded_rows(x, space, lambda xs: halo.resize_bilinear(
        xs.permute(0, 2, 3, 1), (xs.shape[2] * factor, size[1]))
        .permute(0, 3, 1, 2))
    _close(nhwc, want)


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
    halo.check_height(32, 2)
    halo.check_height(36, 1)
    with pytest.raises(ValueError, match="multiple of 8 x "
                       "spatial_partition = 16"):
        halo.check_height(40, 2)
