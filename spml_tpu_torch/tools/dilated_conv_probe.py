"""The hand-written dilated 3x3 conv kernel against cuDNN.

    python -m spml_tpu_torch.tools.dilated_conv_probe

The counterpart of pyscripts/misc/pallas_dilated_conv_probe.py's
__main__ on one CUDA card. At the probe's two ResNet-101 shapes (res4:
B = 8, 64 x 64, 256 -> 256 channels, d = 2; res5: 512 -> 512, d = 4),
from bf16 inputs drawn from seed 0, it prints per shape:

* the kernel's ms (ops/dilated_conv.py, csrc/dilated_conv.cu) and TF/s;
* cuDNN's ms and TF/s (F.conv2d, bf16, channels_last, dilation d,
  padding d), the yardstick, called here and nowhere in the port;
* the relative error max|kernel - cuDNN| / max|cuDNN|, as the probe
  prints it.

Times are CUDA events around ITERS back-to-back calls after one
warm-up call. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F

SHAPES = [("res4 d2 256ch", 8, 64, 64, 256, 256, 2),
          ("res5 d4 512ch", 8, 64, 64, 512, 512, 4)]
ITERS = 50


def cuda_ms(fn, iters):
    """Mean ms of `iters` back-to-back calls of fn, CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cudnn_weight(w):
    """HWIO weights as cuDNN's OIHW in channels_last memory (OHWI)."""
    return w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)


def cudnn_conv(x, w_oihw, d):
    """cuDNN on the NHWC input (as an NCHW view in channels_last) with
    cudnn_weight's weights, the output back as an NHWC view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=d, dilation=d)
    return y.permute(0, 2, 3, 1)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dilated_conv_probe: needs a CUDA card")
    from spml_tpu_torch.ops.dilated_conv import dilated_conv3x3

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    gen = torch.Generator("cuda").manual_seed(0)
    for name, b, h, w, c, o, d in SHAPES:
        x = torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16()
        wt = (0.05 * torch.randn(3, 3, c, o, device="cuda",
                                 generator=gen)).bfloat16()
        w_oihw = cudnn_weight(wt)
        ref = cudnn_conv(x, w_oihw, d).float()
        got = dilated_conv3x3(x, wt, d).float()
        err = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
        t_k = cuda_ms(lambda: dilated_conv3x3(x, wt, d), ITERS)
        t_c = cuda_ms(lambda: cudnn_conv(x, w_oihw, d), ITERS)
        tf = 2 * b * h * w * c * o * 9 / 1e12
        print(f"{name}: kernel {t_k:.4f} ms ({tf / t_k * 1e3:.1f} TF/s)  "
              f"cuDNN {t_c:.4f} ms ({tf / t_c * 1e3:.1f} TF/s)  "
              f"relerr {err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
