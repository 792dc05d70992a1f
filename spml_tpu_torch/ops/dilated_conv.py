"""Dilated 3x3 convolution (stride 1, padding d), NHWC, bf16.

Port of the probe kernel of pyscripts/misc/pallas_dilated_conv_probe.py
(`pallas_conv`): x [B, H, W, C] with weights [3, 3, C, O] (HWIO) ->
[B, H, W, O] in the input dtype, the nine shifted taps summed in float32.
The layouts are the probe's, so the tests compare like with like.

Dispatch: a CUDA tensor goes to the hand-written kernel of
csrc/dilated_conv.cu (TMA loads, bf16 `wgmma`, float32 accumulators; C
and O multiples of 16, else ValueError; a failed build, tensor-map encode
or launch raises); a CPU tensor goes to the plain version,
``dilated_conv3x3_reference``. Forward only: the probe has no backward.

``tile_grid``, ``tile_origin`` and ``box_coords`` mirror the kernel's
tile geometry (which block computes which pixels, and where each K step's
TMA boxes start), so the CPU tests can replay the kernel box by box.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from spml_tpu_torch.ops import _cuda

KERNEL_SOURCE = "dilated_conv"

# launches of the kernel, counted where the wrapper launches it
LAUNCHES = {"dilated_conv3x3": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the kernel's tile: 8 x 16 output pixels of one image times 256 output
# channels; one K step is one tap times 64 input channels
TILE_H, TILE_W, BLOCK_N, CHUNK = 8, 16, 256, 64


def tile_grid(b, h, w, o):
    """(blocks along M, blocks along N) of the kernel's launch."""
    return (b * math.ceil(h / TILE_H) * math.ceil(w / TILE_W),
            math.ceil(o / BLOCK_N))


def tile_origin(tile, h, w):
    """(image, h0, w0) of M tile `tile`: its output row m is the pixel
    (h0 + m // TILE_W, w0 + m % TILE_W)."""
    tiles_h, tiles_w = math.ceil(h / TILE_H), math.ceil(w / TILE_W)
    img, rem = divmod(tile, tiles_h * tiles_w)
    return img, rem // tiles_w * TILE_H, rem % tiles_w * TILE_W


def box_coords(tile, n_tile, step, h, w, c, d):
    """The TMA box coordinates, innermost first, of K step `step` of the
    block (tile, n_tile): the input box {CHUNK, TILE_W, TILE_H, 1} of x as
    [C, W, H, B], and the weight boxes {64, CHUNK, 1} of w as [O, C, 9],
    BLOCK_N // 64 of them side by side along O. Coordinates may lie
    outside the tensor, where the boxes read zeros."""
    chunks = math.ceil(c / CHUNK)
    tap, chunk = divmod(step, chunks)
    img, h0, w0 = tile_origin(tile, h, w)
    i, j = divmod(tap, 3)
    c0 = chunk * CHUNK
    return ((c0, w0 + (j - 1) * d, h0 + (i - 1) * d, img),
            [(n_tile * BLOCK_N + q, c0, tap) for q in range(0, BLOCK_N, 64)])


def _check_shapes(x, w, d):
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"want x [B, H, W, C] and w [3, 3, C, O], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if int(d) < 1:
        raise ValueError(f"dilation {d} < 1")


def dilated_conv3x3_reference(x, w, d):
    """The TPU kernel's own form: pad by d, then nine shifted
    [B, HW, C] @ [C, O] products in float32 (float64 for float64 input),
    summed in that type, cast to the input dtype."""
    _check_shapes(x, w, d)
    b, h, wd, c = x.shape
    acc_t = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x, (0, 0, d, d, d, d))
    acc = torch.zeros((b, h * wd, w.shape[3]), dtype=acc_t, device=x.device)
    for i in range(3):
        for j in range(3):
            tap = xp[:, i * d:i * d + h, j * d:j * d + wd, :]
            acc += tap.reshape(b, h * wd, c).to(acc_t) @ w[i, j].to(acc_t)
    return acc.reshape(b, h, wd, -1).to(x.dtype)


def _operand(t):
    """Contiguous and 16-byte aligned (TMA takes 16-byte aligned bases and
    strides)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dilated_conv3x3(x, w, d):
    """[B, H, W, O] = the dilated 3x3 convolution of x [B, H, W, C] with
    w [3, 3, C, O], stride 1, padding d (out-of-image taps read zero)."""
    _check_shapes(x, w, d)
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if not x.is_cuda:
        return dilated_conv3x3_reference(x, w, d)
    b, h, wd, c = x.shape
    o = w.shape[3]
    if c % 16 or o % 16:
        raise ValueError(f"the kernel takes channel counts that are "
                         f"multiples of 16, got C={c}, O={o}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16, got {x.dtype}, {w.dtype}")
    if max(x.numel(), b * h * wd * o) >= 2**31:
        raise ValueError("the kernel takes int32 sizes")
    xc, wc = _operand(x), _operand(w)
    out = torch.empty((b, h, wd, o), dtype=torch.bfloat16, device=x.device)
    err = _cuda.load(KERNEL_SOURCE).dilated_conv3x3_bf16(
        xc.data_ptr(), wc.data_ptr(), out.data_ptr(), b, h, wd, c, o, int(d),
        _cuda.stream_handle(x.device))
    _cuda.check(err, "dilated_conv3x3_bf16")
    LAUNCHES["dilated_conv3x3"] += 1
    return out
