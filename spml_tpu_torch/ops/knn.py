"""KNN retrieval / ranking over prototypes.

Port of spml_tpu/ops/knn.py::top_k_ranking (reference:
spml/utils/segsort/eval.py:9 in twke18/SPML; invalid prototypes get -1e30
affinity), ::majority_label_from_topk (eval.py:55, the KNN vote of
inference) and ::nearest_neighbor_multiset_labels (the DensePose step's
NN-propagated tags).

Dispatch of top_k_ranking's retrieval: a CUDA tensor goes to the
hand-written kernels of csrc/knn_topk.cu (float32 scores and an exact
top-k in one pass over the bank, then a merge of the chunks' top k; two
launches, no [N, P] matrix; k <= 32, else ValueError, as for any device,
type, shape or layout they do not take); a CPU tensor goes to the plain
version, ``top_k_labels_reference`` (the [N, P] scores and a stable
descending sort). Both rank by score descending, then index ascending,
a NaN score above every number (where torch's descending sort and
jax.lax.top_k put it).
"""

from __future__ import annotations

import math

import torch

from spml_tpu_torch.ops import _cuda, common

NEG_INF = -1e30
KERNEL_SOURCE = "knn_topk"

# launches of the kernels, counted where the wrapper launches them
LAUNCHES = {"knn_topk_partial": 0, "knn_topk_merge": 0}

# the kernels' limits and tiles (csrc/knn_topk.cu): k and D, queries and
# bank rows a tile, candidates the merge holds (chunks x k)
MAX_K, MAX_D, D_STEP = 32, 128, 8
QUERY_TILE, BANK_TILE, MERGE_CAPACITY = 48, 256, 4096
# blocks of the partial kernel resident on an SM (its launch bounds) and
# waves of them the grid should fill (one: each block pays its own warm-up)
BLOCKS_PER_SM, WAVES = 2, 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def plan(n: int, p: int, k: int, sms: int) -> tuple[int, int]:
    """(chunks, rows a chunk) of the partial kernel's grid for n queries
    over p bank rows: about WAVES waves of blocks over the query tiles,
    each chunk a whole number of BANK_TILE rows, none empty, and at most
    MERGE_CAPACITY candidates a query to merge."""
    query_tiles = math.ceil(n / QUERY_TILE)
    chunks = max(1, WAVES * BLOCKS_PER_SM * sms // query_tiles)
    chunks = min(chunks, math.ceil(p / BANK_TILE), MERGE_CAPACITY // k)
    rows = math.ceil(math.ceil(p / chunks) / BANK_TILE) * BANK_TILE
    return math.ceil(p / rows), rows


def top_k_labels_reference(embeddings, prototypes, prototype_labels, top_k,
                           prototype_mask=None):
    """The plain version: labels of each query's top_k prototypes
    [N, top_k] by float32 dot product (prototypes outside the mask at
    -1e30), through the [N, P] scores and a stable descending sort."""
    affinity = embeddings.float() @ prototypes.float().T
    if prototype_mask is not None:
        affinity = torch.where(prototype_mask[None, :], affinity, NEG_INF)
    order = torch.sort(affinity, dim=1, descending=True, stable=True)[1]
    return prototype_labels[order[:, :top_k]]


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def top_k_labels(embeddings, prototypes, prototype_labels, top_k,
                 prototype_mask=None):
    """The same labels [N, top_k], on the card by the two kernels of
    csrc/knn_topk.cu; raises on what they do not take."""
    emb, bank = embeddings.float(), prototypes.float()
    if emb.ndim != 2 or bank.ndim != 2 or bank.shape[1] != emb.shape[1] \
            or prototype_labels.shape != bank.shape[:1]:
        raise ValueError(f"want embeddings [N, D], prototypes [P, D] and "
                         f"labels [P], got {tuple(emb.shape)}, "
                         f"{tuple(bank.shape)}, "
                         f"{tuple(prototype_labels.shape)}")
    (n, d), p = emb.shape, bank.shape[0]
    if not 1 <= top_k <= MAX_K:
        raise ValueError(f"the kernel takes 1 <= k <= {MAX_K}, got {top_k}")
    if d % D_STEP or not 0 < d <= MAX_D:
        raise ValueError(f"the kernel takes D a multiple of {D_STEP} up to "
                         f"{MAX_D}, got {d}")
    if p >= 2**31 - MAX_K:
        raise ValueError("the kernel takes int32 bank indices")
    if prototype_labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"the kernel takes int32 or int64 labels, got "
                         f"{prototype_labels.dtype}")
    if prototype_mask is not None and (prototype_mask.dtype != torch.bool
                                       or prototype_mask.shape != (p,)):
        raise ValueError("the kernel takes a bool prototype mask [P]")
    given = [emb, bank, prototype_labels] + (
        [] if prototype_mask is None else [prototype_mask])
    if any(t.device != emb.device for t in given):
        raise ValueError("embeddings, prototypes, labels and mask on "
                         "different devices")
    if not all(t.is_contiguous() for t in given) or \
            emb.data_ptr() % 16 or bank.data_ptr() % 16:
        raise ValueError("the kernel takes contiguous tensors, the "
                         "embeddings and prototypes 16-byte aligned")
    out = torch.empty((n, top_k), dtype=prototype_labels.dtype,
                      device=emb.device)
    if n == 0:
        return out
    chunks, rows = plan(n, p, top_k, _sm_count(emb.device))
    scratch = torch.empty(2 * chunks * n * top_k, dtype=torch.int32,
                          device=emb.device)
    lib = _cuda.load(KERNEL_SOURCE)
    stream = _cuda.stream_handle(emb.device)
    mask = None if prototype_mask is None else prototype_mask.data_ptr()
    err = lib.knn_topk_partial(emb.data_ptr(), bank.data_ptr(), mask, n, p,
                               d, top_k, chunks, rows,
                               scratch.data_ptr(), stream)
    _cuda.check(err, "knn_topk_partial")
    LAUNCHES["knn_topk_partial"] += 1
    err = lib.knn_topk_merge(scratch.data_ptr(), prototype_labels.data_ptr(),
                             prototype_labels.element_size(), n, p, top_k,
                             chunks, out.data_ptr(), stream)
    _cuda.check(err, "knn_topk_merge")
    LAUNCHES["knn_topk_merge"] += 1
    return out


def top_k_ranking(embeddings: torch.Tensor, labels: torch.Tensor,
                  prototypes: torch.Tensor, prototype_labels: torch.Tensor,
                  top_k: int, query_mask: torch.Tensor | None = None,
                  prototype_mask: torch.Tensor | None = None):
    """Top-k cosine retrieval accuracy + retrieved labels.

    Returns (accuracy scalar, top_k_labels [N, top_k]). Ties go to the
    lower prototype index, as jax.lax.top_k breaks them (the plain
    version's stable descending sort, not torch.topk, whose tie order is
    unspecified; the kernel's (score, index) order).
    """
    top_k = min(top_k, prototypes.shape[0])
    retrieve = top_k_labels if embeddings.is_cuda else top_k_labels_reference
    topk_labels = retrieve(embeddings, prototypes, prototype_labels, top_k,
                           prototype_mask)
    tp = (topk_labels == labels[:, None]).float()
    if query_mask is None:
        return tp.mean(), topk_labels
    m = query_mask.float()[:, None]
    acc = torch.sum(tp * m) / torch.clamp(torch.sum(m) * top_k, min=1.0)
    return acc, topk_labels


def majority_label_from_topk(top_k_labels: torch.Tensor,
                             num_classes: int) -> torch.Tensor:
    """Majority vote over the retrieved labels [..., top_k] -> [...]
    int32; ties go to the lower class (torch.argmax returns the first
    maximum, as jnp.argmax), labels outside [0, num_classes) count for
    none."""
    votes = common.one_hot(top_k_labels, num_classes).sum(dim=-2)
    return torch.argmax(votes, dim=-1).int()


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
