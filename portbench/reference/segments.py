"""Plain spherical k-means and segment formation (twke18/SPML:
spml/utils/segsort/common.py, segment_by_kmeans and its helpers).

Per image (a batch of them in one product each): vMF k-means over the
valid pixels of [embedding, location], L2-normalized, from a uniform
grid of ky x kx cells (cell of row y, column x: round-half-even of
linspace(0, ky - 1) + ky * the same of x), each iteration a masked
per-cluster sum (one-hot product), normalized, then the argmax of the
cosines (first maximum wins). Segments are the unique (cluster,
semantic, instance) triples of an image's valid pixels in ascending key
order, at most `capacity` of them; pixels of a later segment drop out.
Imports nothing of the program.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def normalize(x: torch.Tensor) -> torch.Tensor:
    """x over its L2 norm along the last axis (the norm at least 1e-12)."""
    sq = (x * x).sum(-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=EPS * EPS))


def grid(ky: int, kx: int, h: int, w: int, device) -> torch.Tensor:
    """[h * w] initial cluster of each pixel."""
    y = torch.round(torch.linspace(0.0, ky - 1, h, device=device)).long()
    x = torch.round(torch.linspace(0.0, kx - 1, w, device=device)).long()
    return (y[:, None] + ky * x[None, :]).reshape(-1)


def cluster_sums(x: torch.Tensor, labels: torch.Tensor, k: int,
                 weights: torch.Tensor) -> torch.Tensor:
    """[..., k, D]: the weighted sum of the rows of x [..., N, D] of each
    label [..., N]."""
    onehot = (labels[..., None] == torch.arange(k, device=x.device)).to(
        x.dtype) * weights[..., None].to(x.dtype)
    return torch.einsum("...np,...nd->...pd", onehot, x)


def kmeans(x: torch.Tensor, init: torch.Tensor, k: int, iterations: int,
           weights: torch.Tensor) -> torch.Tensor:
    """[..., N] cluster of each unit row of x [..., N, D]."""
    labels = init
    for _ in range(iterations):
        centres = normalize(cluster_sums(x, labels, k, weights))
        labels = torch.argmax(torch.einsum("...nd,...pd->...np", x, centres),
                              dim=-1)
    return labels


def segments(emb: torch.Tensor, loc: torch.Tensor, sem: torch.Tensor,
             inst: torch.Tensor, clusters: tuple[int, int], capacity: int,
             iterations: int, ignore: int):
    """A batch: emb [B, h, w, D] raw, loc [B, h, w, L], sem / inst [B, h,
    w].

    Returns a dict of pixel fields [B, h * w] (segment id in [0,
    capacity), valid) and segment fields [B, capacity] (valid, semantic,
    instance, cluster); dropped pixels have id capacity - 1 and are not
    valid."""
    b, h, w, d = emb.shape
    e = normalize(emb.float().reshape(b, h * w, d))
    x = normalize(torch.cat([e, loc.float().reshape(b, h * w, -1)], -1))
    sem, inst = sem.reshape(b, -1).long(), inst.reshape(b, -1).long()
    valid = sem != ignore
    k = clusters[0] * clusters[1]
    init = grid(*clusters, h, w, emb.device).expand(b, -1)
    cl = kmeans(x, init, k, iterations, valid.float())
    keys = cl * 65536 + sem.clamp(0, 255) * 256 + inst.clamp(0, 255)
    out = [_image(keys[i], valid[i], capacity, ignore) for i in range(b)]
    return {f: torch.stack([o[f] for o in out]) for f in out[0]}


def _image(keys, valid, capacity, ignore):
    """One image's segments from its pixel keys."""
    uniq, inv = torch.unique(keys[valid], return_inverse=True)
    ids = torch.full_like(keys, capacity - 1)
    ids[valid] = inv
    keep = valid & (torch.where(valid, ids, capacity) < capacity)
    ids = torch.where(keep, ids, capacity - 1)
    n = min(len(uniq), capacity)
    seg_valid = torch.zeros(capacity, dtype=torch.bool, device=keys.device)
    seg_valid[:n] = True
    return {"ids": ids, "pixel_valid": keep, "valid": seg_valid,
            "semantic": _pad((uniq // 256) % 256, n, capacity, ignore),
            "instance": _pad(uniq % 256, n, capacity, 0),
            "cluster": _pad(uniq // 65536, n, capacity, 0)}


def _pad(v: torch.Tensor, n: int, capacity: int, value: int) -> torch.Tensor:
    """The first n entries of v, then `value` up to `capacity`."""
    return torch.cat([v[:n], v.new_full((capacity - n,), value)])
