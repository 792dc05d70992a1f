"""The schedule of the JOINT dE and dP kernels (K2, K3), replayed on the CPU.

csrc/segsort_joint.cu's grad_tile_kernel cuts the (pixel, prototype) pairs
into tiles: dE blocks own 128 pixels and walk the valid prototypes in
64-row tiles; dP blocks own 128 valid prototypes and walk the pixels of
their chunk in 64-row tiles, and reduce_tiles_kernel adds a prototype
tile's chunks in chunk order.
ops/segsort_loss.py mirrors that schedule (joint_grad_emb_tiles,
joint_grad_proto_tiles). These tests check that every (pixel, valid
prototype) pair is covered exactly once and no block touches a prototype
row at or past num_valid, then replay dE and dP tile by tile, in the
kernels' order, in float64 against the autograd of
joint_segsort_stats_reference (rtol 1e-10: both sides are float64; only
the order of the sums differs).
"""

import numpy as np
import pytest
import torch

from spml_tpu_torch.ops import segsort_loss as fused

N_PIX, N_PROTO = 200, 150  # ragged: 200 = 128 + 72 = 3 * 64 + 8


def _case(n, p, nv, d, seed):
    rng = np.random.RandomState(seed)
    protos = rng.randn(p, d)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    own = rng.randint(0, p, n)  # some own prototypes lie past num_valid
    emb = protos[own] + 0.4 * rng.randn(n, d) / np.sqrt(d)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    plab = np.where(rng.rand(p) < 0.9, rng.randint(0, 4, p), -1)
    t = torch.from_numpy
    return dict(emb=t(emb), pix_lab=t(rng.randint(0, 4, n)), own_idx=t(own),
                pix_tags=t(rng.randint(0, 16, n)), protos=t(protos),
                proto_lab=t(plab), proto_tags=t(rng.randint(0, 16, p)),
                proto_valid=t(rng.randint(0, 2, p)),
                num_valid=torch.tensor([nv]), grads=t(rng.randn(6, n)))


def _coeff(c, kappa_a, kappa_o):
    """c[n, k] = kappa_a s_a g_a + kappa_o s_o g_o, the kernels'
    pair_masks / pair_coeff, zero at or past num_valid."""
    own, same_a, diff_a, live = fused._label_masks(
        c["pix_lab"], c["own_idx"], c["proto_lab"], c["num_valid"])
    same_o, diff_o = fused._tag_masks(c["pix_tags"], c["proto_tags"],
                                      c["proto_valid"], live)
    logits = c["emb"] @ c["protos"].T
    s_a = torch.exp(kappa_a * logits)
    s_o = s_a * s_a if kappa_o == 2 * kappa_a else torch.exp(kappa_o * logits)
    g = c["grads"]

    def pick(masks, rows):
        return sum(torch.where(m, g[r][:, None], 0.0)
                   for m, r in zip(masks, rows))
    return (kappa_a * s_a * pick((own, same_a, diff_a), (0, 1, 2))
            + kappa_o * s_o * pick((own, same_o, diff_o), (3, 4, 5)))


def _reference(c, kappa_a, kappa_o):
    e = c["emb"].clone().requires_grad_(True)
    p = c["protos"].clone().requires_grad_(True)
    s = fused.joint_segsort_stats_reference(
        e, c["pix_lab"], c["own_idx"], c["pix_tags"], p, c["proto_lab"],
        c["proto_tags"], c["proto_valid"], c["num_valid"], kappa_a, kappa_o)
    return torch.autograd.grad((s * c["grads"]).sum(), (e, p))


def _tile_rows(rows, size):
    """A tile: at most `size` rows, starting on a multiple of size."""
    return len(rows) <= size and rows.start % size == 0


@pytest.mark.parametrize("blocks", [None, 5], ids=["wrapper_grid",
                                                   "five_blocks"])
@pytest.mark.parametrize("nv", [0, 1, 70, N_PROTO],
                         ids=["none_valid", "one_valid", "70_valid",
                              "all_valid"])
@pytest.mark.parametrize("d,kappas", [(16, (6.0, 12.0)), (32, (6.0, 10.0)),
                                      (64, (6.0, 12.0))],
                         ids=["d16_square", "d32_two_exps", "d64_square"])
def test_tiles_cover_each_pair_once_and_replay_the_gradients(d, kappas, nv,
                                                             blocks):
    n, p = N_PIX, N_PROTO
    own_rows, stream_rows = fused.OWN_ROWS, fused.STREAM_ROWS
    blocks = fused.joint_dp_blocks(p) if blocks is None else blocks
    case = _case(n, p, nv, d, seed=d + nv)
    coeff = _coeff(case, *kappas)
    emb, protos = case["emb"], case["protos"]

    # dE: each block writes its own pixel rows once, summing the
    # prototype tiles in loop order
    seen = torch.zeros(n, p, dtype=torch.int64)
    d_emb = torch.full((n, d), float("nan"), dtype=torch.float64)
    emb_tiles = fused.joint_grad_emb_tiles(n, nv)
    assert len(emb_tiles) == -(-n // own_rows)
    for pix, ptiles in emb_tiles:
        assert _tile_rows(pix, own_rows) and pix.stop <= n
        acc = torch.zeros(len(pix), d, dtype=torch.float64)
        for pro in ptiles:
            assert _tile_rows(pro, stream_rows) and pro.stop <= nv
            seen[pix.start:pix.stop, pro.start:pro.stop] += 1
            acc += coeff[pix.start:pix.stop, pro.start:pro.stop] @ \
                protos[pro.start:pro.stop]
        assert torch.isnan(d_emb[pix.start:pix.stop]).all()
        d_emb[pix.start:pix.stop] = acc
    assert (seen[:, :nv] == 1).all() and (seen[:, nv:] == 0).all()

    # dP: one [OWN_ROWS, D] partial per working block, then each row's
    # chunks in chunk order
    assert blocks >= -(-p // own_rows)
    chunks, proto_blocks = fused.joint_grad_proto_tiles(n, nv, blocks)
    seen.zero_()
    partial = {}
    for b, pro, ptiles in proto_blocks:
        assert b < blocks and _tile_rows(pro, own_rows) and pro.stop <= nv
        part = torch.zeros(own_rows, d, dtype=torch.float64)
        for pix in ptiles:
            assert _tile_rows(pix, stream_rows) and pix.stop <= n
            seen[pix.start:pix.stop, pro.start:pro.stop] += 1
            part[:len(pro)] += coeff[pix.start:pix.stop,
                                     pro.start:pro.stop].T @ \
                emb[pix.start:pix.stop]
        partial[b] = part
    assert (seen[:, :nv] == 1).all() and (seen[:, nv:] == 0).all()
    assert len(partial) == len(proto_blocks) == -(-nv // own_rows) * chunks
    d_protos = torch.zeros(p, d, dtype=torch.float64)
    for k in range(nv):
        for c in range(chunks):
            d_protos[k] += partial[(k // own_rows) * chunks + c][
                k % own_rows]

    want_emb, want_protos = _reference(case, *kappas)
    torch.testing.assert_close(d_emb, want_emb, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(d_protos, want_protos, rtol=1e-10, atol=1e-12)
    assert (d_protos[nv:] == 0).all()


def test_flagship_split():
    """At the flagship's shapes (N = 131072, P = 6144, ~1195 valid rows)
    the 264 blocks of the dP grid become 10 prototype tiles x 26 chunks
    of 78 or 79 pixel tiles: 260 blocks at work, a 8.65 MB scratch."""
    n, p, nv = 131072, 6144, 1195
    blocks = fused.joint_dp_blocks(p)
    assert blocks == 264
    chunks, work = fused.joint_grad_proto_tiles(n, nv, blocks)
    assert chunks == 26 and len(work) == 10 * 26
    assert {len(ptiles) for _, _, ptiles in work} == {78, 79}
    assert sum(len(ptiles) for _, _, ptiles in work) == \
        10 * n // fused.STREAM_ROWS
    assert blocks * fused.OWN_ROWS * 64 * 4 == 8650752
    # a grid smaller than the prototype tiles is refused by the C side;
    # the wrapper's grid is never that small
    assert fused.joint_dp_blocks(100 * fused.OWN_ROWS) == 264
    assert fused.joint_dp_blocks(300 * fused.OWN_ROWS + 1) == 301
