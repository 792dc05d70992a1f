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
* the float64 plain version against torch's float64 conv2d (rtol 1e-12).
"""

import functools

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
