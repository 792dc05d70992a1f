"""The port's dilated 3x3 conv (ops/dilated_conv.py, the plain version
of the CUDA kernel K10) against the probe it ports,
pyscripts/misc/pallas_dilated_conv_probe.py, on the CPU.

* against the probe's Pallas kernel `pallas_conv`, run in interpret mode
  (its pl.pallas_call patched to interpret=True for the call), from the
  same bf16 values: exactly equal (both sum the nine float32 tap products
  of exact bf16 products, then round once to bf16);
* against the probe's `native_conv` (XLA's dilated convolution) at
  d in {1, 2, 4} and ragged H, W: within one bf16 unit in the last place
  of the output (rtol 2^-7: both sides round a float32 sum once to bf16,
  in their own summation order, so a sum near a rounding boundary may
  land one unit apart) plus atol 1e-6 * max|ref|;
* the float64 plain version against torch's float64 conv2d (rtol 1e-12);
* the kernel's tile geometry (`tile_grid`, `tile_origin`, `box_coords`,
  which csrc/dilated_conv.cu mirrors) replayed box by box: each block's
  K steps read zero-filled TMA boxes at the kernel's coordinates, their
  products are summed and stored in the box's row order with the
  kernel's masks; in float64 that equals the plain version (rtol 1e-12)
  and writes every output element once.
"""

import functools
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyscripts.misc.pallas_dilated_conv_probe as probe
from spml_tpu_torch.ops import dilated_conv as dc

BF16_ULP = 2.0 ** -7  # relative, at most


def _inputs(seed, b, h, w, c, o):
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(b, h, w, c), jnp.bfloat16)
    wt = jnp.asarray(rng.randn(3, 3, c, o) * 0.2, jnp.bfloat16)
    return x, wt


def _torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


def _port(x, wt, d):
    return dc.dilated_conv3x3(_torch(x), _torch(wt), d).float().numpy()


@pytest.mark.parametrize("d", [2, 4])
def test_plain_version_matches_pallas_probe_interpret(d):
    x, wt = _inputs(d, 2, 9, 7, 16, 8)
    orig = probe.pl.pallas_call
    probe.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        want = probe.pallas_conv(x, wt, d)
    finally:
        probe.pl.pallas_call = orig
    assert want.dtype == jnp.bfloat16
    got = dc.dilated_conv3x3(_torch(x), _torch(wt), d)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 7, 8)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("d,hw", [(1, (5, 11)), (2, (9, 7)), (4, (6, 13)),
                                  (4, (3, 3))],
                         ids=["d1", "d2", "d4", "d4_dilation_past_edge"])
def test_plain_version_matches_native_conv(d, hw):
    x, wt = _inputs(10 + d, 3, *hw, 32, 16)
    want = np.asarray(probe.native_conv(x, wt, d).astype(jnp.float32))
    np.testing.assert_allclose(_port(x, wt, d), want, rtol=BF16_ULP,
                               atol=1e-6 * np.abs(want).max())


def test_float64_plain_version_matches_conv2d():
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 10, 9, 16))
    w = torch.from_numpy(rng.randn(3, 3, 16, 32))
    for d in (1, 3):
        want = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=d,
            dilation=d).permute(0, 2, 3, 1)
        got = dc.dilated_conv3x3_reference(x, w, d)
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_bad_shapes_raise():
    x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="w \\[3, 3, C, O\\]"):
        dc.dilated_conv3x3(x, torch.zeros(3, 3, 8, 16), 1)
    with pytest.raises(ValueError, match="dilation"):
        dc.dilated_conv3x3(x, torch.zeros(3, 3, 16, 16), 0)


def _tma_box(t, coords, box):
    """What a TMA load of `box` elements at `coords` (both innermost
    first, as the kernel gives them) writes: t's elements inside t, zeros
    outside it."""
    coords, box = coords[::-1], box[::-1]  # to t's dimension order
    out = t.new_zeros(box)
    src, dst = [], []
    for start, n, size in zip(coords, box, t.shape):
        lo, hi = max(start, 0), min(start + n, size)
        if lo >= hi:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - start, hi - start))
    out[tuple(dst)] = t[tuple(src)]
    return out


def _replay_kernel(x, w, d):
    """The kernel's arithmetic, block by block and box by box."""
    b, h, wd, c = x.shape
    o = w.shape[3]
    w9 = w.reshape(9, c, o)  # HWIO, read by the kernel as it is
    out = torch.full((b, h, wd, o), math.nan, dtype=x.dtype)
    m_tiles, n_tiles = dc.tile_grid(b, h, wd, o)
    rows = torch.arange(dc.TILE_H * dc.TILE_W)
    for tile in range(m_tiles):
        img, h0, w0 = dc.tile_origin(tile, h, wd)
        hh, ww = h0 + rows // dc.TILE_W, w0 + rows % dc.TILE_W
        inside = (hh < h) & (ww < wd)
        for nt in range(n_tiles):
            acc = torch.zeros(len(rows), dc.BLOCK_N, dtype=x.dtype)
            for step in range(9 * math.ceil(c / dc.CHUNK)):
                xc, wcs = dc.box_coords(tile, nt, step, h, wd, c, d)
                a = _tma_box(x, xc, (dc.CHUNK, dc.TILE_W, dc.TILE_H, 1))
                # [CHUNK, BLOCK_N]: the weight boxes side by side along O
                bt = torch.cat([_tma_box(w9, wc, (64, dc.CHUNK, 1))[0]
                                for wc in wcs], dim=1)
                acc += a.reshape(-1, dc.CHUNK) @ bt
            n0 = nt * dc.BLOCK_N
            n1 = min(o, n0 + dc.BLOCK_N)
            assert torch.isnan(out[img, hh[inside], ww[inside], n0:n1]).all()
            out[img, hh[inside], ww[inside], n0:n1] = acc[inside, :n1 - n0]
    return out


@pytest.mark.parametrize(
    "b,h,w,c,o,d",
    [(2, 9, 7, 16, 32, 1), (3, 13, 20, 48, 16, 2), (1, 6, 33, 32, 144, 4),
     (1, 3, 3, 16, 16, 4), (1, 10, 17, 80, 272, 3), (1, 8, 16, 16, 16, 2),
     (1, 8, 40, 32, 48, 1)],
    ids=["ragged_d1", "ragged_d2_c48", "ragged_d4_o144",
         "d4_every_tap_but_centre_outside", "two_chunks_two_n_tiles",
         "one_whole_tile_c16", "three_tiles_across"])
def test_kernel_tile_geometry_replays_plain_version(b, h, w, c, o, d):
    rng = np.random.RandomState(b * 1000 + h * 10 + d)
    x = torch.from_numpy(rng.randn(b, h, w, c))
    wt = torch.from_numpy(rng.randn(3, 3, c, o))
    got = _replay_kernel(x, wt, d)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, dc.dilated_conv3x3_reference(x, wt, d),
                               rtol=1e-12, atol=1e-12)


def test_box_coords_of_a_tile():
    """Block (tile 5, N tile 1) of x [2, 20, 40, C = 80] at d = 3: image
    0, tile row 1 of 3, tile column 2 of 3; K step 13 is tap 6 (the row
    below and column left), channel chunk 1; its weight boxes start at
    output channels 256, 320, 384 and 448."""
    assert dc.tile_grid(2, 20, 40, 272) == (18, 2)
    assert dc.tile_origin(5, 20, 40) == (0, 8, 32)
    assert dc.tile_origin(9, 20, 40) == (1, 0, 0)
    assert dc.box_coords(5, 1, 13, 20, 40, 80, 3) == (
        (64, 29, 11, 0), [(256, 64, 6), (320, 64, 6), (384, 64, 6),
                          (448, 64, 6)])
    assert dc.box_coords(0, 0, 0, 20, 40, 80, 3)[0] == (0, -3, -3, 0)
