"""Tensor algebra shared across the segsort ops.

Port of spml_tpu/ops/common.py (reference: spml/utils/general/common.py
in twke18/SPML). Everything is static-shape; per-segment sums are one-hot
matrix products, whose summation order is fixed, instead of index_add_,
which sums in a run-dependent atomic order on the card.
"""

from __future__ import annotations

import torch

from spml_tpu_torch.parallel import halo

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


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or in float64 when it is float64 (a float64 step
    stays float64)."""
    return x if x.dtype == torch.float64 else x.float()


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


def resize_labels(labels: torch.Tensor, size: tuple[int, int],
                  rows: int | None = None) -> torch.Tensor:
    """Nearest-neighbour label resize to `size` = (global rows, width),
    torch 'nearest' index rule: src = floor(dst * in/out), computed in
    float32.

    Inside a parallel/halo.py::sharded() block, labels are this rank's
    rows of labels `rows` rows high, and the result is this rank's rows
    of the resize (halo.partition): the source rows come from the global
    coordinates and are fetched from the ranks that own them
    (halo.take_rows), exactly."""
    h, w = labels.shape[-2:]
    nh, nw = size
    if halo.current() is None:
        rows = h
    ys = torch.floor(torch.arange(nh, dtype=torch.float32)
                     * (rows / nh)).long().tolist()
    xs = torch.floor(torch.arange(nw, dtype=torch.float32,
                                  device=labels.device)
                     * (w / nw)).long()
    lead = labels.shape[:-2]
    out = halo.take_rows(labels.reshape(-1, 1, h, w), rows, ys)
    return out.reshape(*lead, -1, w).index_select(-1, xs)


def generate_location_features(height: int, width: int,
                               device=None) -> torch.Tensor:
    """Normalized (y, x) grid in [0, 1] stacked last -> [H, W, 2]."""
    y = torch.linspace(0.0, 1.0, height, device=device)
    x = torch.linspace(0.0, 1.0, width, device=device)
    yy = y[:, None].expand(height, width)
    xx = x[None, :].expand(height, width)
    return torch.stack([yy, xx], dim=-1)


def calculate_principal_components(embeddings: torch.Tensor,
                                   num_components: int = 3) -> torch.Tensor:
    """Principal directions [D, num_components] of [N, D] embeddings (for
    PCA visualisation); each direction's sign is the SVD's."""
    centered = embeddings - embeddings.mean(dim=0, keepdim=True)
    _, _, vt = torch.linalg.svd(centered, full_matrices=False)
    return vt[:num_components].T


def pca(embeddings: torch.Tensor, num_components: int = 3,
        principal_components: torch.Tensor | None = None) -> torch.Tensor:
    """[..., D] embeddings projected on their (or the given) principal
    directions -> [..., num_components]."""
    shape = embeddings.shape
    flat = embeddings.reshape(-1, shape[-1])
    if principal_components is None:
        principal_components = calculate_principal_components(
            flat, num_components)
    return (flat @ principal_components).reshape(*shape[:-1],
                                                 num_components)
