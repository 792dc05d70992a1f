"""Plain PyTorch single-scale KNN prediction of one image (twke18/SPML:
pyscripts/inference/inference.py:114-228, spml/models/predictions/
segsort.py:68-125). Imports nothing of the program.

The normalized image is padded with zeros (bottom, right) to its bucket
(crop + k x stride a side, at least the crop), each crop x crop window at
the given stride goes through the network in eval mode, its embeddings
resized to the window and L2-normalized, and the windows are averaged
where they overlap. k-means (segments.py) runs on the padded map with the
pixels inside the image valid, location features [y, x] of the padded
map; each cluster's prototype is the normalized sum of its valid pixels'
embeddings. Each prototype retrieves the labels of its top 20 bank rows
by cosine (ties to the lower row: candidates are merged from blocks of
the bank), and the majority label (ties to the lower class) labels the
cluster's pixels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import model as net_lib
from portbench.reference import segments as seg_lib

TOP_K = 20
BANK_BLOCK = 1 << 18  # bank rows a block of the top-k search


def bucket(size: int, crop: int, stride: int) -> int:
    if size <= crop:
        return crop
    return crop + int(math.ceil((size - crop) / stride)) * stride


def window_starts(pad: int, crop: int, stride: int) -> list[int]:
    n = int(math.ceil((pad - crop) / stride)) + 1
    return [int(e) - crop for e in np.linspace(crop, pad, n).astype(np.int32)]


def stitch(net: net_lib.Net, image: np.ndarray, crop, stride, device):
    """The overlap-averaged normalized embedding map [Hb, Wb, D]."""
    h, w = image.shape[:2]
    hb, wb = bucket(h, crop[0], stride[0]), bucket(w, crop[1], stride[1])
    img = torch.zeros(hb, wb, 3, device=device)
    img[:h, :w] = torch.as_tensor(image, device=device)
    total = count = None
    for sy in window_starts(hb, crop[0], stride[0]):
        for sx in window_starts(wb, crop[1], stride[1]):
            win = img[sy:sy + crop[0], sx:sx + crop[1]].to(torch.bfloat16)
            with torch.no_grad():
                e = seg_lib.normalize(net.embeddings(win[None], True)[0])
            if total is None:
                total = torch.zeros(hb, wb, e.shape[-1], device=device)
                count = torch.zeros(hb, wb, 1, device=device)
            total[sy:sy + crop[0], sx:sx + crop[1]] += e
            count[sy:sy + crop[0], sx:sx + crop[1]] += 1.0
    return total / count


def top_k_labels(queries, bank_p, bank_l, k=TOP_K):
    """[Q, k] labels of each query's k best bank rows by dot product,
    ties to the lower row."""
    scores, rows = [], []
    for start in range(0, bank_p.shape[0], BANK_BLOCK):
        s = queries @ bank_p[start:start + BANK_BLOCK].T
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        scores.append(v)
        rows.append(i + start)
    v, i = torch.cat(scores, 1), torch.cat(rows, 1)
    by_row = torch.argsort(i, dim=1)  # lower row first among equal scores
    v, i = v.gather(1, by_row), i.gather(1, by_row)
    best = torch.sort(v, dim=1, descending=True, stable=True)[1][:, :k]
    return bank_l[i.gather(1, best)]


def predict(net, image, cfg: dict, bank, device) -> dict:
    """{stitched [Hb, Wb, D], ids [Hb * Wb], topk [K, 20], pred [h, w]}
    of one image; cfg: the inference overrides of the configuration."""
    h, w = image.shape[:2]
    crop, stride = cfg["test"]["crop_size"], cfg["test"]["stride"]
    emb = stitch(net, image, crop, stride, device)
    hb, wb, _ = emb.shape
    ky, kx = cfg["network"]["kmeans_num_clusters"]
    k = ky * kx
    valid = torch.zeros(hb, wb, dtype=torch.bool, device=device)
    valid[:h, :w] = True
    valid = valid.reshape(-1)
    e = seg_lib.normalize(emb.reshape(-1, emb.shape[-1]))
    x = seg_lib.normalize(torch.cat(
        [e, net_lib.location(hb, wb, device).reshape(-1, 2)], 1))
    cl = seg_lib.kmeans(x[None], seg_lib.grid(ky, kx, hb, wb, device)[None],
                        k, cfg["network"]["kmeans_iterations"],
                        valid.float()[None])[0]
    ids = torch.where(valid, cl, 0)
    protos = seg_lib.normalize(seg_lib.cluster_sums(
        e[None], ids[None], k, valid.float()[None]))[0]
    topk = top_k_labels(protos, bank[0], bank[1])
    c = cfg["dataset"]["num_classes"]
    votes = (topk[..., None] == torch.arange(c, device=device)).sum(1)
    pred = torch.argmax(votes, 1)[ids].reshape(hb, wb)[:h, :w]
    return {"stitched": emb, "ids": ids, "topk": topk, "pred": pred,
            "valid": valid}
