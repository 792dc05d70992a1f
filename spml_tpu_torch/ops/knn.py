"""KNN retrieval / ranking over prototypes.

Port of spml_tpu/ops/knn.py::top_k_ranking (reference:
spml/utils/segsort/eval.py:9 in twke18/SPML). Invalid prototypes get
-1e30 affinity.
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
