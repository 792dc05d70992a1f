"""Embedding-affinity random walk for pseudo-label propagation.

Port of spml_tpu/ops/randomwalk.py (reference in twke18/SPML:
pyscripts/inference/pseudo_camrw_crf.py:139-170, pseudo_softmaxrw_crf.py:
146-164, pseudo_softmax.py:184-192):
* pixel affinity on a stride-8 grid: A = exp(5 * cos(e_i, e_j) - 5);
* transition T = A ** beta (beta 20), each column normalized to sum 1;
* T squared `walk_steps` times (T ** 64 at 6 steps);
* scores' = scores @ T.

Float32 throughout, as in the JAX package. The [n, n] products are plain
dense matmuls (n = 2852 at VOC's 500 x 375 grid); pixel_affinity and
the walk turn TF32 off (utils/device.py::float32_matmuls) so that the
card computes them in float32 whatever a caller set before; exp(5c) **
20 underflows at c below ~0.13 in float32 already.
"""

from __future__ import annotations

import numpy as np
import torch

from spml_tpu_torch.utils.device import float32_matmuls


def integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x ** y for a positive integer y by binary exponentiation, the
    products in the order jax.lax.integer_pow multiplies them (x ** 20 =
    x ** 4 * x ** 16), so the float32 roundings are the JAX package's."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def pixel_affinity(embeddings: torch.Tensor) -> torch.Tensor:
    """exp(5 cos - 5) pairwise affinity [n, n] of [n, d] unit rows."""
    float32_matmuls()
    e = embeddings.float()
    return torch.exp((e @ e.T) * 5.0 - 5.0)


def random_walk_from_affinity(aff: torch.Tensor, scores: torch.Tensor,
                              beta: int = 20,
                              walk_steps: int = 6) -> torch.Tensor:
    """scores [C, n] walked over a precomputed affinity [n, n] (the
    reference averages the two flips' affinities before the walk,
    pseudo_camrw_crf.py:151-163). Returns [C, n] float32."""
    float32_matmuls()
    aff = integer_pow(aff.float(), beta)
    trans = aff / aff.sum(dim=0, keepdim=True)
    for _ in range(walk_steps):
        trans = trans @ trans
    return scores.float() @ trans


def random_walk(embeddings: torch.Tensor, scores: torch.Tensor,
                beta: int = 20, walk_steps: int = 6) -> torch.Tensor:
    """The walk from [n, d] L2-normalized grid embeddings: scores [C, n]
    -> [C, n]."""
    return random_walk_from_affinity(pixel_affinity(embeddings), scores,
                                     beta, walk_steps)


def cam_to_full_scores(cam_dict: dict, num_classes: int, height: int,
                       width: int, bg_alpha: float = 6.0) -> np.ndarray:
    """[C, H, W] float32 scores of a CAM dict with the power background
    prior (pseudo_camrw_crf.py:103-112): CAM key k is class k + 1, and
    the background is (1 - max over the classes) ** bg_alpha."""
    full = np.zeros((num_classes, height, width), np.float32)
    for k, v in cam_dict.items():
        full[int(k) + 1] = v
    full[0] = np.power(1.0 - np.max(full[1:], axis=0), bg_alpha)
    return full
