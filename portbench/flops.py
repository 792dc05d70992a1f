"""Operation and byte counts from the configuration's shapes, and the
published peaks of one NVIDIA H100 SXM (dense, 700 W).

conv_layers() lists the network's convolutions from the published
architecture (portbench/reference/model.py's shapes); model FLOPs count
2 x cin x cout x k x k per output pixel of each. segsort_bound_ms() is
a frozen copy of chip_smoke.py:4126-4177 (bounds): bytes with each input
read once and each output written once, operations per (pixel,
prototype) pair, with the products counted once at the operand type's
tensor-core peak (TF32 for float32 operands, bf16 for bf16) and the rest
(exponentials, masked sums) at the float32 peak.
"""

from __future__ import annotations

from portbench.reference.model import (ARCHS, ASPP_DILATIONS, PSPP_BINS,
                                       PSPP_DIM, blocks)

PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def _out(n: int, k: int, stride: int, pad: int, dil: int = 1) -> int:
    return (n + 2 * pad - dil * (k - 1) - 1) // stride + 1


def conv_layers(backbone_types: str, dim: int, height: int, width: int,
                num_classes: int | None = None):
    """[(name, cin, cout, k, out_h, out_w, trained)] of the embedding
    network on height x width images, and with num_classes the classifier
    head on its embeddings. The stem and res2 are frozen."""
    depth, head, _ = ARCHS[backbone_types]
    out = []
    h, w = _out(height, 3, 2, 1), _out(width, 3, 2, 1)
    out += [("stem.0", 3, 64, 3, h, w, False),
            ("stem.3", 64, 64, 3, h, w, False),
            ("stem.6", 64, 128, 3, h, w, False)]
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    for stage, i, cin, planes, stride, d, down in blocks(depth):
        trained = stage > 2
        name = f"res{stage}.{i}"
        h2, w2 = _out(h, 3, stride, d, d), _out(w, 3, stride, d, d)
        out += [(f"{name}.conv1", cin, planes, 1, h, w, trained),
                (f"{name}.conv2", planes, planes, 3, h2, w2, trained),
                (f"{name}.conv3", planes, 4 * planes, 1, h2, w2, trained)]
        if down:
            out.append((f"{name}.downsample", cin, 4 * planes, 1, h2, w2,
                        trained))
        h, w = h2, w2
    if head == "aspp":
        out += [(f"aspp_{i + 1}", 2048, dim, 3, h, w, True)
                for i in range(len(ASPP_DILATIONS))]
    else:
        out += [(f"pspp_{i + 1}", 2048, PSPP_DIM, 1, s, s, True)
                for i, s in enumerate(PSPP_BINS)]
        out += [("pspp.conv", 2048 + len(PSPP_BINS) * PSPP_DIM, PSPP_DIM, 3,
                 h, w, True), ("pspp.out", PSPP_DIM, dim, 1, h, w, True)]
    if num_classes is not None:
        eh, ew = 2 * h, 2 * w  # the x2 upsampled embeddings
        out += [("classifier.0", dim, 2 * dim, 3, eh, ew, True),
                ("classifier.4", 2 * dim, num_classes, 1, eh, ew, True)]
    return out


def conv_flops(layer) -> float:
    _, cin, cout, k, h, w, _ = layer
    return 2.0 * cin * cout * k * k * h * w


def train_step_flops(backbone_types, dim, batch, crop, num_classes) -> float:
    """Model FLOPs of one train step: every conv forward once, and twice
    more for the backward of each trained conv (no recomputation)."""
    layers = conv_layers(backbone_types, dim, crop, crop, num_classes)
    return batch * sum(conv_flops(l) * (3.0 if l[6] else 1.0)
                       for l in layers)


def forward_flops(backbone_types, dim, height, width) -> float:
    """Model FLOPs of the embedding network's forward on one image."""
    return sum(conv_flops(l) for l in conv_layers(backbone_types, dim,
                                                  height, width))


def segsort_bound_ms(family: str, n: int, nv: int, d: int, rows: int,
                     bf16: bool = False) -> float:
    """The least time (ms) of one SegSort loss's forward statistics and
    both gradients: `rows` of the n pixels carry the loss, nv prototypes
    are valid, width d; family "joint" (sem_ann + sem_occ, 6 statistics)
    or "hard" (sem_ann, 3)."""
    ns = 6 if family == "joint" else 3
    eb = 2 if bf16 else 4
    if family == "joint":  # rows carry label, own / tag, valid
        pix_row, proto_row = d * eb + 12, d * eb + 12
        ops_stats, ops_grad = 2 * d + 10, 4 * d + 14
    else:  # rows carry label, own / label
        pix_row, proto_row = d * eb + 8, d * eb + 4
        ops_stats, ops_grad = 2 * d + 6, 4 * d + 8
    protos_in, grads_in = nv * proto_row, ns * rows * 4
    work = [  # bytes, operations a pair, product flops a pair, pairs
        (rows * pix_row + protos_in + ns * rows * 4, ops_stats, 2 * d,
         rows * nv),
        (rows * pix_row + grads_in + protos_in + rows * d * 4, ops_grad,
         4 * d, rows * nv),
        (rows * pix_row + grads_in + protos_in + nv * d * 4, ops_grad,
         4 * d, rows * nv),
    ]
    peak = PEAK_BF16 if bf16 else PEAK_TF32
    total = 0.0
    for nbytes, ops, prod, pairs in work:
        t_ops = pairs * (prod / peak + (ops - prod) / PEAK_F32)
        total += max(t_ops, nbytes / PEAK_BYTES)
    return total * 1e3
