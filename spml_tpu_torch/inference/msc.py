"""Multi-scale and flip inference: the image pyramid and its average.

Port of spml_tpu/inference/msc.py (reference in twke18/SPML:
pyscripts/inference/inference_msc.py:114-245 and
spml/utils/general/others.py:10-47, create_image_pyramid): for each
(scale, flip) member, resize the image, predict class probabilities (the
top-20 one-hot mean for KNN, the softmax for the classifier), resize them
bilinearly back to the base size, un-flip, average over the pyramid, then
argmax.

The device pyramid keeps the whole pyramid on the card: the base image
goes up once, each member is resized and flipped from it on the device
(engine.device_member_resize), its probabilities are resized, un-flipped
and summed at the base size there, and only the sum comes down, cast to
float16 by default before the division by the member count (the JAX
package's transfer; the CRF, the argmax and the prob floor of the
pseudo-labels read those rounded values). msc_predict_labels_device
finishes the argmax on the device too. The resizes are two dense
products with bilinear weights (half-pixel centres, edge clamp, no
antialias: cv2.INTER_LINEAR, the reference's probability resize) in
float32. The JAX package's msc_predict_probs_bucketed, the same numbers
through per-member host resizes (its tests hold it equal to the device
pyramid), has no counterpart.

Engines: any object with config, bucket_shape(h, w), upload_image(image),
predict_member_probs(base, base_hw, member_hw, flip, *member_args) and
accumulate_member_pair(acc, base, base_hw, member_hw, out_hw,
*member_args): the KNN InferenceEngine (member_args the memory bank) and
the SoftmaxInferenceEngine (none).
"""

from __future__ import annotations

import numpy as np
import torch

from spml_tpu_torch.data import transforms
from spml_tpu_torch.models.spp import resize_bilinear

_TRANSFER = {np.dtype(np.float16): torch.float16,
             np.dtype(np.float32): torch.float32}


def image_pyramid(image: np.ndarray, scales, is_flip: bool):
    """Yields (scaled image, scale, flipped) of an [H, W, 3] image, the
    flipped member after the unflipped one at each scale."""
    flips = [False, True] if is_flip else [False]
    for scale in scales:
        h, w = image.shape[:2]
        scaled = (transforms._resize_image(image, int(h * scale),
                                           int(w * scale))
                  if scale != 1 else image)
        for f in flips:
            yield (scaled[:, ::-1].copy() if f else scaled), scale, f


def msc_predict_probs(predict_probs_fn, image: np.ndarray, scales,
                      is_flip: bool = True) -> np.ndarray:
    """The pyramid's mean probabilities [H, W, C] through host-resized
    members: predict_probs_fn(member image) -> [h, w, C] probabilities at
    the member's size (an array or a tensor)."""
    h, w = image.shape[:2]
    acc, n = None, 0
    for img, _, flipped in image_pyramid(image, scales, is_flip):
        probs = torch.as_tensor(predict_probs_fn(img)).float()
        if probs.shape[:2] != (h, w):
            probs = resize_bilinear(probs[None], (h, w))[0]
        if flipped:
            probs = probs.flip(1)
        acc = probs if acc is None else acc + probs
        n += 1
    return (acc / n).cpu().numpy()


def bilinear_resize_weights(n_out: int, n_in: int, valid_out: int,
                            valid_in: int, reverse: bool,
                            device=None) -> torch.Tensor:
    """[n_out, n_in] float32 bilinear sampling weights taking the first
    valid_in input rows to valid_out output rows (half-pixel centres,
    edge clamp), in the JAX package's float32 arithmetic. reverse reflects
    the source coordinate inside the valid rows: the weights resample the
    flipped input without making it. Rows past valid_out sample the
    clamped edge; columns past valid_in get no weight."""
    ratio = float(np.float32(valid_in) / np.float32(valid_out))
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    src = torch.clamp((i + 0.5) * ratio - 0.5, 0.0, valid_in - 1.0)
    if reverse:
        src = (valid_in - 1.0) - src
    y = torch.arange(n_in, dtype=torch.float32, device=device)
    return torch.clamp(1.0 - (src[:, None] - y[None, :]).abs(), min=0.0)


def bilinear_resize(x: torch.Tensor, in_hw, out_hw, out_shape=None,
                    flip: bool = False) -> torch.Tensor:
    """x[:in_h, :in_w] ([H, W, C] float32, the rest ignored) resized to
    out_hw, un-flipped horizontally when flip; out_shape (default out_hw)
    may be larger, its extra rows and columns sampling the clamped
    edge."""
    oh, ow = out_shape or out_hw
    wr = bilinear_resize_weights(oh, x.shape[0], out_hw[0], in_hw[0], False,
                                 x.device)
    wc = bilinear_resize_weights(ow, x.shape[1], out_hw[1], in_hw[1], flip,
                                 x.device)
    tmp = torch.einsum("oi,iwc->owc", wr, x)
    return torch.einsum("pw,owc->opc", wc, tmp)


def resize_accumulate(acc: torch.Tensor, probs: torch.Tensor, in_hw,
                      flip: bool) -> torch.Tensor:
    """acc + probs[:in_h, :in_w] resized to acc's [h, w] (un-flipped
    first when flip): one pyramid member added to the sum at the base
    size."""
    return acc + bilinear_resize(probs, in_hw, tuple(acc.shape[:2]),
                                 flip=flip)


@torch.no_grad()
def _msc_accumulate_device(engine, image: np.ndarray, member_args, scales,
                           is_flip: bool):
    """The device pyramid: (sum over the members of their probabilities
    at the base size [h, w, C] float32, the member count)."""
    h, w = image.shape[:2]
    base = engine.upload_image(image)
    acc = torch.zeros(h, w, engine.config.dataset.num_classes,
                      device=base.device)
    n = 0
    for scale in scales:
        member_hw = (int(h * scale), int(w * scale))
        if is_flip:  # both flips of the scale in one window forward
            acc = engine.accumulate_member_pair(acc, base, (h, w),
                                                member_hw, *member_args)
            n += 2
        else:
            probs = engine.predict_member_probs(base, (h, w), member_hw,
                                                False, *member_args)
            acc = resize_accumulate(acc, probs, member_hw, flip=False)
            n += 1
    return acc, n


def msc_predict_probs_device(engine, image: np.ndarray, member_args, scales,
                             is_flip: bool = True,
                             transfer_dtype=np.float16) -> np.ndarray:
    """The pyramid's mean probabilities [h, w, C] float32 through the
    device pyramid: the sum cast to transfer_dtype on the device,
    downloaded, divided by the member count on the host. float16 is the
    JAX package's default and numbers; np.float32 keeps the sum's
    bits."""
    return msc_predict_probs_device_async(engine, image, member_args,
                                          scales, is_flip, transfer_dtype)()


def msc_predict_probs_device_async(engine, image: np.ndarray, member_args,
                                   scales, is_flip: bool = True,
                                   transfer_dtype=np.float16):
    """msc_predict_probs_device without the wait: queues the pyramid and
    the copy of its sum into pinned host memory, and returns resolve(),
    which waits for the copy and returns what msc_predict_probs_device
    returns. resolve may run on another thread (the runners' CRF
    pool)."""
    acc, n = _msc_accumulate_device(engine, image, member_args, scales,
                                    is_flip)
    small = acc.to(_TRANSFER[np.dtype(transfer_dtype)])
    done = None
    if small.is_cuda:
        host = torch.empty(small.shape, dtype=small.dtype, pin_memory=True)
        host.copy_(small, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    else:
        host = small

    def resolve():
        if done is not None:
            done.synchronize()
        return host.numpy().astype(np.float32) / n

    return resolve


@torch.no_grad()
def resize_argmax(acc: torch.Tensor, final_hw) -> torch.Tensor:
    """argmax over the classes of acc [h, w, C] resized bilinearly to
    final_hw, uint8 on acc's device. The reference argmaxes after
    averaging and resizing (inference_msc.py:238-242); a positive divisor
    changes no argmax, so the sum goes in as it is."""
    res = bilinear_resize(acc, tuple(acc.shape[:2]), tuple(final_hw))
    return res.argmax(dim=-1).to(torch.uint8)


def msc_predict_labels_device(engine, image: np.ndarray, member_args, scales,
                              is_flip: bool = True,
                              final_hw=None) -> np.ndarray:
    """The pyramid's labels [fh, fw] uint8 (final_hw, default the image's
    size) finished on the device: the float32 sum resized to final_hw and
    argmaxed there, one byte a pixel downloaded, no float16 step. For the
    paths without a CRF it is the reference's average -> resize ->
    argmax."""
    acc, _ = _msc_accumulate_device(engine, image, member_args, scales,
                                    is_flip)
    return resize_argmax(acc, final_hw or image.shape[:2]).cpu().numpy()
