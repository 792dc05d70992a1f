"""Tensor algebra shared across the segsort ops.

Port of spml_tpu/ops/common.py (reference: spml/utils/general/common.py
in twke18/SPML). Everything is static-shape; per-segment sums are one-hot
matrix products, whose summation order is fixed, instead of index_add_,
which sums in a run-dependent atomic order on the card.
"""

from __future__ import annotations

import torch

EPS_NORM = 1e-12


def normalize_embedding(embeddings: torch.Tensor,
                        eps: float = EPS_NORM) -> torch.Tensor:
    """L2-normalizes along the last axis with an eps floor on the norm.

    The floor is clamped inside the sqrt: sqrt'(0) = inf would otherwise
    give 0 * inf = NaN gradients for all-zero rows (empty-segment
    prototypes).
    """
    sq = torch.sum(embeddings * embeddings, dim=-1, keepdim=True)
    return embeddings / torch.sqrt(torch.clamp(sq, min=eps * eps))


def one_hot(labels: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    """One-hot encoding; out-of-range labels give all-zero rows."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """Sum of `values` [..., N, D] per segment id [..., N] ->
    [..., num_segments, D]; `weights` [..., N] scales each row."""
    oh = one_hot(seg_ids, num_segments, dtype=values.dtype)
    if weights is not None:
        oh = oh * weights[..., None].to(values.dtype)
    return torch.einsum("...np,...nd->...pd", oh, values)


def segment_mean(values: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of `values` per segment (empty segments -> zeros)."""
    if weights is None:
        weights = torch.ones(values.shape[:-1], dtype=values.dtype,
                             device=values.device)
    sums = segment_sum(values, seg_ids, num_segments, weights)
    counts = segment_sum(weights[..., None].to(values.dtype), seg_ids,
                         num_segments)
    return sums / torch.clamp(counts, min=1.0)


def resize_labels(labels: torch.Tensor, size: tuple[int, int]
                  ) -> torch.Tensor:
    """Nearest-neighbour label resize, torch 'nearest' index rule:
    src = floor(dst * in/out), computed in float32."""
    h, w = labels.shape[-2:]
    nh, nw = size
    dev = labels.device
    ys = torch.floor(torch.arange(nh, dtype=torch.float32, device=dev)
                     * (h / nh)).long()
    xs = torch.floor(torch.arange(nw, dtype=torch.float32, device=dev)
                     * (w / nw)).long()
    return labels.index_select(-2, ys).index_select(-1, xs)


def generate_location_features(height: int, width: int,
                               device=None) -> torch.Tensor:
    """Normalized (y, x) grid in [0, 1] stacked last -> [H, W, 2]."""
    y = torch.linspace(0.0, 1.0, height, device=device)
    x = torch.linspace(0.0, 1.0, width, device=device)
    yy = y[:, None].expand(height, width)
    xx = x[None, :].expand(height, width)
    return torch.stack([yy, xx], dim=-1)
