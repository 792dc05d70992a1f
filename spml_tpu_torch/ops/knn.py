"""KNN retrieval / ranking over prototypes.

Port of spml_tpu/ops/knn.py::top_k_ranking (reference:
spml/utils/segsort/eval.py:9 in twke18/SPML; invalid prototypes get -1e30
affinity) and ::nearest_neighbor_multiset_labels (the DensePose step's
NN-propagated tags).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def top_k_ranking(embeddings: torch.Tensor, labels: torch.Tensor,
                  prototypes: torch.Tensor, prototype_labels: torch.Tensor,
                  top_k: int, query_mask: torch.Tensor | None = None,
                  prototype_mask: torch.Tensor | None = None):
    """Top-k cosine retrieval accuracy + retrieved labels.

    Returns (accuracy scalar, top_k_labels [N, top_k]). Ties go to the
    lower prototype index, as jax.lax.top_k breaks them: a stable
    descending sort, not torch.topk, whose tie order is unspecified.
    """
    affinity = embeddings.float() @ prototypes.float().T
    if prototype_mask is not None:
        affinity = torch.where(prototype_mask[None, :], affinity, NEG_INF)
    top_k = min(top_k, prototypes.shape[0])
    order = torch.sort(affinity, dim=1, descending=True, stable=True)[1]
    topk_labels = prototype_labels[order[:, :top_k]]
    tp = (topk_labels == labels[:, None]).float()
    if query_mask is None:
        return tp.mean(), topk_labels
    m = query_mask.float()[:, None]
    acc = torch.sum(tp * m) / torch.clamp(torch.sum(m) * top_k, min=1.0)
    return acc, topk_labels


def nearest_neighbor_multiset_labels(
        embeddings: torch.Tensor, prototypes: torch.Tensor,
        prototype_semantic_labels: torch.Tensor,
        batch_embedding_labels: torch.Tensor,
        batch_prototype_labels: torch.Tensor, num_classes: int,
        top_k: int = 3, threshold: float = 0.95,
        prototype_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-hot labels [N, num_classes] propagated from the nearest
    labelled prototypes of the same image (reference
    gather_multiset_labels_per_batch_by_nearest_neighbor,
    spml/models/utils.py:157).

    Cosine scores; prototypes of another image, without a class label
    (>= num_classes) or outside prototype_mask are pushed below every
    score (min - 1). Of the top_k (ties to the lower index, as
    jax.lax.top_k), those scoring below `threshold` count as no class;
    the rest are unioned into the result.
    """
    dists = embeddings.float() @ prototypes.float().T
    allowed = ((batch_embedding_labels[:, None]
                == batch_prototype_labels[None, :])
               & (prototype_semantic_labels < num_classes)[None, :])
    if prototype_mask is not None:
        allowed = allowed & prototype_mask[None, :]
    dists = torch.where(allowed, dists, dists.min() - 1.0)
    top_k = min(top_k, prototypes.shape[0])
    nn_dists, nn_idx = torch.sort(dists, dim=1, descending=True, stable=True)
    nn_dists, nn_idx = nn_dists[:, :top_k], nn_idx[:, :top_k]
    set_labels = torch.where(nn_dists < threshold, num_classes,
                             prototype_semantic_labels[nn_idx].long())
    hit = set_labels[..., None] == torch.arange(num_classes,
                                                device=dists.device)
    return hit.any(dim=1).long()
