"""The FLOP and roofline arithmetic against counts made by hand."""

from __future__ import annotations

import pytest

from portbench import flops


def test_resnet10_layers_by_hand():
    # ResNet-10 DeepLab at 64 x 64: stem at 32^2, res2 at 16^2, res3-5
    # at 8^2 (output stride 8), ASPP at 8^2
    layers = {l[0]: l for l in flops.conv_layers("panoptic_deeplab_10", 8,
                                                 64, 64, 21)}
    assert layers["stem.0"][1:] == (3, 64, 3, 32, 32, False)
    assert layers["res2.0.conv1"][1:] == (128, 64, 1, 16, 16, False)
    assert layers["res3.0.conv2"][1:] == (128, 128, 3, 8, 8, True)
    assert layers["res3.0.downsample"][1:] == (256, 512, 1, 8, 8, True)
    assert layers["res5.0.conv2"][1:] == (512, 512, 3, 8, 8, True)
    assert layers["aspp_4"][1:] == (2048, 8, 3, 8, 8, True)
    assert layers["classifier.0"][1:] == (8, 16, 3, 16, 16, True)
    assert flops.conv_flops(layers["stem.0"]) == 2 * 3 * 64 * 9 * 32 * 32
    total = sum(flops.conv_flops(l) for l in layers.values())
    frozen = sum(flops.conv_flops(l) for l in layers.values() if not l[6])
    assert flops.train_step_flops("panoptic_deeplab_10", 8, 2, 64, 21) == \
        pytest.approx(2 * (3 * total - 2 * frozen))


def test_resnet101_forward_is_the_published_size():
    # ResNet-101 DeepLab OS8 at 512^2, by hand: res4 23 x (2 x 256 x 1024
    # + 9 x 256^2) x 64^2 x 2 = 210 GFLOP, res5 3 x (2 x 512 x 2048 +
    # 9 x 512^2) x 64^2 x 2 = 110 and its shortcut 17, ASPP 4 x 9 x 2048
    # x 64 x 64^2 x 2 = 39: ~375 GFLOP before the stem, res2 and res3
    f = flops.forward_flops("panoptic_deeplab_101", 64, 512, 512)
    assert 0.39e12 < f < 0.42e12
    n = len(flops.conv_layers("panoptic_deeplab_101", 64, 512, 512))
    assert n == 3 + 3 * (3 + 4 + 23 + 3) + 4 + 4  # stem, blocks, shortcuts


def test_segsort_bound_by_hand():
    # hard family, D 32, 100 carrying rows, 10 prototypes: three parts,
    # each the larger of the operations and the bytes
    n, nv, d, rows = 1000, 10, 32, 100
    ops = [rows * nv * (2 * d / 495e12 + 6 / 67e12),
           rows * nv * (4 * d / 495e12 + 8 / 67e12),
           rows * nv * (4 * d / 495e12 + 8 / 67e12)]
    pix, proto = d * 4 + 8, d * 4 + 4
    byt = [rows * pix + nv * proto + 3 * rows * 4,
           rows * pix + 3 * rows * 4 + nv * proto + rows * d * 4,
           rows * pix + 3 * rows * 4 + nv * proto + nv * d * 4]
    want = sum(max(o, b / 3.35e12) for o, b in zip(ops, byt)) * 1e3
    assert flops.segsort_bound_ms("hard", n, nv, d, rows) == \
        pytest.approx(want)
    # the joint family's work grows with the pairs, and bf16 is faster
    a = flops.segsort_bound_ms("joint", 131072, 1200, 64, 131072)
    assert a > flops.segsort_bound_ms("joint", 131072, 600, 64, 131072)
    assert flops.segsort_bound_ms("joint", 131072, 1200, 64, 131072,
                                  bf16=True) < a
