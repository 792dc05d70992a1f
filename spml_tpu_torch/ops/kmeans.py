"""Static-shape spherical (vMF) k-means and segment formation.

Port of spml_tpu/ops/kmeans.py (reference: spml/utils/segsort/common.py
in twke18/SPML). Every image keeps its full pixel grid plus a validity
mask, and the JAX package's vmap over images is a leading batch axis
here:

* the M-step is a masked one-hot batched matrix product (fixed summation
  order, so the E-step argmax does not depend on the run), the E-step a
  batched matrix product + argmax (first max wins, as jnp.argmax);
* torch.unique-style segment compaction is a stable sort + adjacent-diff
  + cumsum under a fixed per-image capacity; overflowed and invalid
  pixels go to bin capacity-1 with keep=False.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spml_tpu_torch.ops import common

INVALID_KEY = 2**31 - 1


def initialize_cluster_labels(num_clusters: tuple[int, int],
                              img_dims: tuple[int, int],
                              device=None) -> torch.Tensor:
    """Uniform grid partition labels [H, W] in [0, ky*kx): linspace +
    round half to even; label = y + ky * x."""
    ky, kx = num_clusters
    h, w = img_dims
    y = torch.round(torch.linspace(0.0, ky - 1, h, device=device)).long()
    x = torch.round(torch.linspace(0.0, kx - 1, w, device=device)).long()
    return y[:, None] + ky * x[None, :]


def calculate_prototypes_from_labels(embeddings: torch.Tensor,
                                     labels: torch.Tensor,
                                     num_prototypes: int,
                                     weights: torch.Tensor | None = None
                                     ) -> torch.Tensor:
    """Masked M-step: L2-normalized per-label sum of embeddings
    ([..., N, D], [..., N] -> [..., num_prototypes, D])."""
    sums = common.segment_sum(embeddings, labels, num_prototypes, weights)
    return common.normalize_embedding(sums)


def find_nearest_prototypes(embeddings: torch.Tensor,
                            prototypes: torch.Tensor) -> torch.Tensor:
    """E-step: argmax cosine similarity (embeddings pre-normalized)."""
    sims = torch.einsum("...nd,...pd->...np", embeddings, prototypes)
    return torch.argmax(sims, dim=-1)


def kmeans_with_initial_labels(embeddings: torch.Tensor,
                               initial_labels: torch.Tensor,
                               num_clusters: int, iterations: int,
                               weights: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """vMF k-means: `iterations` x (M-step, E-step)."""
    labels = initial_labels
    for _ in range(iterations):
        protos = calculate_prototypes_from_labels(
            embeddings, labels, num_clusters, weights)
        labels = find_nearest_prototypes(embeddings, protos)
    return labels


class Segments(NamedTuple):
    """Fixed-capacity segments of a batch of images.

    pixel_segment_ids [B, N] int64 in [0, capacity); pixel_valid [B, N]
    bool; segment_valid [B, capacity] bool; segment_semantic /
    segment_instance / segment_cluster [B, capacity] int64.
    """
    pixel_segment_ids: torch.Tensor
    pixel_valid: torch.Tensor
    segment_valid: torch.Tensor
    segment_semantic: torch.Tensor
    segment_instance: torch.Tensor
    segment_cluster: torch.Tensor


def compact_unique_segments(keys: torch.Tensor, valid: torch.Tensor,
                            capacity: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """torch.unique(return_inverse=True) along the last axis under a fixed
    capacity.

    Returns (seg_ids [..., N] int64 ranked in ascending key order, keep
    [..., N] bool). Invalid and overflowed pixels get capacity-1 with
    keep=False.
    """
    masked = torch.where(valid, keys.long(), INVALID_KEY)
    sorted_keys, order = torch.sort(masked, dim=-1, stable=True)
    newflag = torch.ones_like(sorted_keys, dtype=torch.bool)
    newflag[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    ranks = torch.cumsum(newflag.long(), dim=-1) - 1
    seg_sorted = torch.where(sorted_keys != INVALID_KEY, ranks, capacity)
    seg_ids = torch.empty_like(seg_sorted).scatter_(-1, order, seg_sorted)
    keep = (seg_ids < capacity) & valid
    return torch.clamp(seg_ids, max=capacity - 1), keep


def _segment_attrs(seg_ids: torch.Tensor, keep: torch.Tensor, attrs,
                   fills, capacity: int):
    """Per-segment attribute readout + validity, in exact integers.

    All kept pixels of a segment share each attribute by construction of
    the composite key, so scattering any of them gives the value; pixels
    not kept scatter into a spare bin that is dropped.
    """
    idx = torch.where(keep, seg_ids, capacity)
    lead = seg_ids.shape[:-1]
    present = torch.zeros(*lead, capacity + 1, dtype=torch.bool,
                          device=seg_ids.device)
    present.scatter_(-1, idx, True)
    present = present[..., :capacity]
    vals = []
    for a, fill in zip(attrs, fills):
        out = torch.full((*lead, capacity + 1), fill, dtype=a.dtype,
                         device=a.device)
        out.scatter_(-1, idx, a)
        vals.append(torch.where(present, out[..., :capacity], fill))
    return vals, present


def segment_batch(embeddings: torch.Tensor, local_features: torch.Tensor,
                  semantic_labels: torch.Tensor,
                  instance_labels: torch.Tensor,
                  num_clusters: tuple[int, int], capacity: int,
                  iterations: int = 10, ignore_index: int = 255,
                  label_cap: int = 256):
    """Batched segment formation (reference segment_by_kmeans:270).

    1. vMF k-means on (embedding ++ location) over valid pixels from a
       uniform-grid initialization;
    2. segments = unique (cluster, semantic, instance) triples per image.

    embeddings [B, H, W, D] raw; local_features [B, H, W, L];
    semantic/instance labels [B, H, W] integer.

    Returns (Segments, emb_flat [B, N, D], emb_loc [B, N, D+L]), the last
    two L2-normalized.
    """
    b, h, w, d = embeddings.shape
    emb = common.normalize_embedding(embeddings.float())
    emb_flat = emb.reshape(b, h * w, d)
    loc_flat = local_features.float().reshape(b, h * w, -1)
    emb_loc = common.normalize_embedding(
        torch.cat([emb_flat, loc_flat], dim=-1))

    k = num_clusters[0] * num_clusters[1]
    grid = initialize_cluster_labels(num_clusters, (h, w),
                                     device=embeddings.device).reshape(-1)
    sem = semantic_labels.reshape(b, h * w).long()
    inst = instance_labels.reshape(b, h * w).long()
    valid = sem != ignore_index

    cluster = kmeans_with_initial_labels(
        emb_loc, grid.expand(b, -1), k, iterations, valid.float())

    if k * label_cap * label_cap >= 2**31:
        raise ValueError("composite segment key overflows int32")
    keys = (cluster * (label_cap * label_cap)
            + torch.clamp(sem, 0, label_cap - 1) * label_cap
            + torch.clamp(inst, 0, label_cap - 1))
    seg_ids, keep = compact_unique_segments(keys, valid, capacity)
    (seg_sem, seg_inst, seg_cluster), seg_valid = _segment_attrs(
        seg_ids, keep, (sem, inst, cluster), (ignore_index, 0, 0), capacity)
    segs = Segments(pixel_segment_ids=seg_ids, pixel_valid=keep,
                    segment_valid=seg_valid, segment_semantic=seg_sem,
                    segment_instance=seg_inst, segment_cluster=seg_cluster)
    return segs, emb_flat, emb_loc


def segment_batch_single_group(embeddings: torch.Tensor,
                               local_features: torch.Tensor,
                               semantic_labels: torch.Tensor,
                               num_clusters: tuple[int, int],
                               iterations: int = 10,
                               ignore_index: int = 255):
    """segment_batch for inference's fake labels, where every valid pixel
    shares one (semantic, instance) pair: the segments are the occupied
    k-means clusters, and a segment's id is its cluster's.

    Same inputs as segment_batch without the instance labels; returns
    (Segments, emb_flat [B, N, D]) with capacity ky * kx. Invalid pixels
    get id 0 and pixel_valid False; an empty cluster is an invalid
    segment slot.
    """
    b, h, w, d = embeddings.shape
    k = num_clusters[0] * num_clusters[1]
    emb = common.normalize_embedding(embeddings.float())
    emb_flat = emb.reshape(b, h * w, d)
    loc_flat = local_features.float().reshape(b, h * w, -1)
    emb_loc = common.normalize_embedding(
        torch.cat([emb_flat, loc_flat], dim=-1))
    grid = initialize_cluster_labels(num_clusters, (h, w),
                                     device=embeddings.device).reshape(-1)
    valid = semantic_labels.reshape(b, h * w) != ignore_index
    cluster = kmeans_with_initial_labels(
        emb_loc, grid.expand(b, -1), k, iterations, valid.float())
    seg_ids = torch.where(valid, cluster, 0)
    present = torch.zeros(b, k + 1, dtype=torch.bool, device=emb.device)
    present.scatter_(1, torch.where(valid, cluster, k), True)
    seg_valid = present[:, :k]
    ignore = torch.full_like(seg_valid, ignore_index, dtype=torch.long)
    segs = Segments(
        pixel_segment_ids=seg_ids, pixel_valid=valid,
        segment_valid=seg_valid,
        segment_semantic=torch.where(seg_valid, 0, ignore),
        segment_instance=torch.zeros(b, k, dtype=torch.long,
                                     device=emb.device),
        segment_cluster=torch.arange(k, device=emb.device).expand(b, k))
    return segs, emb_flat


def find_majority_label_index(semantic_labels: torch.Tensor,
                              cluster_labels: torch.Tensor,
                              num_clusters: int, num_classes: int,
                              valid: torch.Tensor | None = None):
    """Majority semantic label of each cluster and the pixels that agree
    with their cluster's (reference common.py:221): (select [N] bool,
    majority [num_clusters] int32). Labels outside [0, num_classes) vote
    for none; ties go to the lower class; an empty cluster's majority is
    0."""
    oh_sem = common.one_hot(semantic_labels, num_classes)
    if valid is not None:
        oh_sem = oh_sem * valid[:, None].to(oh_sem.dtype)
    counts = common.segment_sum(oh_sem, cluster_labels, num_clusters)
    majority = torch.argmax(counts, dim=-1).int()
    pixel_majority = majority[torch.clamp(cluster_labels, 0,
                                          num_clusters - 1)]
    select = pixel_majority == semantic_labels
    if valid is not None:
        select = select & valid
    return select, majority
