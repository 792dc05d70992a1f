"""Pixel-to-segment contrastive (SegSort / SetSegSort) losses, dense.

Port of spml_tpu/ops/losses.py (reference: spml/utils/segsort/loss.py in
twke18/SPML, group_mode='segsort+'). Pixels and prototypes stay at fixed
capacity with boolean masks: zeroing a masked prototype's similarity is
exactly removing it from the sums. This dense formulation materializes
the [N, P] similarity matrix; it is the img_sim loss of the train step,
the loss path without the fused kernels, and the yardstick of the fused
joint kernels' plain version (ops/segsort_loss.py).

Every function accepts leading batch axes: embeddings [..., N, D],
prototypes [..., P, D], labels [..., N] / [..., P].
"""

from __future__ import annotations

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of `values` over the last axis where `mask` holds."""
    m = mask.to(values.dtype)
    return torch.sum(values * m, dim=-1) / torch.clamp(
        torch.sum(m, dim=-1), min=1.0)


def segsort_log_likelihood(embeddings: torch.Tensor,
                           own_segment_ids: torch.Tensor,
                           same_mask: torch.Tensor,
                           diff_mask: torch.Tensor,
                           prototypes: torch.Tensor,
                           concentration: float) -> torch.Tensor:
    """-log p(pixel -> its segment) under the vMF mixture ("segsort+"):
    numerator = same-class sims minus the own sim when positive, else the
    own sim; denominator = numerator + different-class sims.

    Returns [..., N] per-pixel negative log likelihood.
    """
    logits = torch.einsum("...nd,...pd->...np", embeddings, prototypes)
    sims = torch.exp(logits * concentration)
    cols = torch.arange(sims.shape[-1], device=sims.device)
    own_onehot = own_segment_ids[..., None] == cols
    own = torch.sum(torch.where(own_onehot, sims, 0.0), dim=-1)
    same_sum = torch.sum(sims * same_mask.to(sims.dtype), dim=-1) - own
    numerator = torch.where(same_sum > 0, same_sum, own)
    diff_sum = torch.sum(sims * diff_mask.to(sims.dtype), dim=-1)
    return -torch.log(numerator / (diff_sum + numerator))


def segsort_loss(embeddings, semantic_labels, own_segment_ids, prototypes,
                 prototype_semantic_labels, concentration, pixel_mask,
                 prototype_mask, reduction: str = "mean"):
    """SegSortLoss with hard labels: same/diff is label equality against
    each valid prototype's label. reduction "mean" = masked mean over the
    pixels, "none" = per-pixel [..., N] log likelihood."""
    lab = semantic_labels[..., :, None]
    plab = prototype_semantic_labels[..., None, :]
    pmask = prototype_mask[..., None, :]
    same = (lab == plab) & pmask
    diff = (lab != plab) & pmask
    ll = segsort_log_likelihood(embeddings, own_segment_ids, same, diff,
                                prototypes, concentration)
    if reduction == "none":
        return ll
    return _masked_mean(ll, pixel_mask)


def set_segsort_loss(embeddings, semantic_tags, own_segment_ids, prototypes,
                     prototype_semantic_tags, concentration, pixel_mask,
                     prototype_mask, reduction: str = "mean"):
    """SetSegSortLoss with multi-hot tags: same = the tag sets intersect,
    diff = they do not; both restricted to valid prototypes."""
    affinity = torch.einsum("...nc,...pc->...np", semantic_tags.float(),
                            prototype_semantic_tags.float())
    pmask = prototype_mask[..., None, :]
    same = (affinity > 0) & pmask
    diff = (affinity == 0) & pmask
    ll = segsort_log_likelihood(embeddings, own_segment_ids, same, diff,
                                prototypes, concentration)
    if reduction == "none":
        return ll
    return _masked_mean(ll, pixel_mask)
