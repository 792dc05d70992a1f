"""The schedule of the tiled SegSort kernels, replayed on the CPU: the
JOINT stats, dE and dP (K1, K2, K3), the hard-label stats, dE and dP (K4,
K5, K6) and the tag-set stats, dE and dP (K7, K8, K9).

csrc/segsort_joint.cu's stats_tile_kernel and grad_tile_kernel cut the
(pixel, prototype) pairs into tiles: stats and dE blocks own 128 pixels
and walk the valid prototypes in 64-row tiles (in the stats kernel lane t
of a quad takes the tile's rows 8 nt + 2 t + e, and the quad adds its four
sums in a fixed order; in the dE kernel only the warps of 32 pixels with a
nonzero cotangent take products, and a block with none walks no tile);
dP blocks own 128 valid prototypes and walk the pixels of their chunk in
64-row tiles, and reduce_tiles_kernel adds a prototype tile's chunks in
chunk order.
ops/segsort_loss.py mirrors that schedule (stats_tiles, grad_emb_tiles,
grad_proto_tiles). These tests check that every (pixel, valid prototype)
pair is covered exactly once (in dE, every pair of a live warp's pixels)
and no block touches a prototype row at or past num_valid, then replay
the statistics, dE and dP tile by tile, in the kernels' order, in float64
against the plain versions and their autograd
(joint_segsort_stats_reference, segsort_stats_reference,
set_segsort_stats_reference; rtol 1e-10: both sides are float64; only the
order of the sums differs). The rows a dE skips are exactly 0.
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


def _set_coeff(c, kappa):
    """c[n, k] = kappa s g of the tag-set family (pair_coeff<SET>): own,
    tag sets intersect, disjoint; zero at or past num_valid."""
    own, live = fused._own_mask(c["own_idx"], c["protos"].shape[0],
                                c["num_valid"])
    same, diff = fused._tag_masks(c["pix_tags"], c["proto_tags"],
                                  c["proto_valid"], live)
    s = torch.exp(kappa * (c["emb"] @ c["protos"].T))
    g = c["grads"]
    return kappa * s * sum(torch.where(m, g[r][:, None], 0.0)
                           for m, r in zip((own, same, diff), (0, 1, 2)))


def _hard_coeff(c, kappa):
    """c[n, k] = kappa s g of the hard-label family (pair_coeff<HARD>):
    own, same and different label (prototype label >= 0); zero at or past
    num_valid."""
    own, same, diff, _ = fused._label_masks(c["pix_lab"], c["own_idx"],
                                            c["proto_lab"], c["num_valid"])
    s = torch.exp(kappa * (c["emb"] @ c["protos"].T))
    g = c["grads"]
    return kappa * s * sum(torch.where(m, g[r][:, None], 0.0)
                           for m, r in zip((own, same, diff), (0, 1, 2)))


def _joint_stats(c, e, p, kappa_a, kappa_o):
    return fused.joint_segsort_stats_reference(
        e, c["pix_lab"], c["own_idx"], c["pix_tags"], p, c["proto_lab"],
        c["proto_tags"], c["proto_valid"], c["num_valid"], kappa_a, kappa_o)


def _hard_stats(c, e, p, kappa):
    return fused.segsort_stats_reference(
        e, c["pix_lab"], c["own_idx"], p, c["proto_lab"], c["num_valid"],
        kappa)


def _set_stats(c, e, p, kappa):
    return fused.set_segsort_stats_reference(
        e, c["pix_tags"], c["own_idx"], p, c["proto_tags"], c["proto_valid"],
        c["num_valid"], kappa)


def _reference(c, stats, *kappas):
    """(dE, dP) of sum(stats * grads) by autograd of a plain version."""
    e = c["emb"].clone().requires_grad_(True)
    p = c["protos"].clone().requires_grad_(True)
    s = stats(c, e, p, *kappas)
    g = c["grads"][:s.shape[0]]
    return torch.autograd.grad((s * g).sum(), (e, p))


def _tile_rows(rows, size):
    """A tile: at most `size` rows, starting on a multiple of size."""
    return len(rows) <= size and rows.start % size == 0


def _replay_de(coeff, protos, nv, grads):
    """dE from the tiled dE kernel's schedule: each block writes its own
    pixel rows once, its live warps' rows summing the prototype tiles in
    loop order, the others +0; checks that each (pixel of a live warp,
    valid prototype) pair is covered once and no other pair at all.
    Returns (dE, which rows lie in a live warp)."""
    n, (p, d) = coeff.shape[0], protos.shape
    seen = torch.zeros(n, p, dtype=torch.int64)
    live = torch.zeros(n, dtype=torch.bool)
    d_emb = torch.full((n, d), float("nan"), dtype=torch.float64)
    emb_tiles = fused.grad_emb_tiles(n, nv, grads)
    assert len(emb_tiles) == -(-n // fused.OWN_ROWS)
    for pix, warps, ptiles in emb_tiles:
        assert _tile_rows(pix, fused.OWN_ROWS) and pix.stop <= n
        assert warps or not ptiles  # a block with no live warp walks none
        acc = torch.zeros(len(pix), d, dtype=torch.float64)
        for w in warps:
            assert _tile_rows(w, fused.WARP_ROWS)
            assert pix.start <= w.start and w.stop <= pix.stop
            live[w.start:w.stop] = True
            for pro in ptiles:
                assert _tile_rows(pro, fused.STREAM_ROWS) and pro.stop <= nv
                seen[w.start:w.stop, pro.start:pro.stop] += 1
                acc[w.start - pix.start:w.stop - pix.start] += \
                    coeff[w.start:w.stop, pro.start:pro.stop] @ \
                    protos[pro.start:pro.stop]
        assert torch.isnan(d_emb[pix.start:pix.stop]).all()
        d_emb[pix.start:pix.stop] = acc
    assert (seen[live, :nv] == 1).all() and (seen[~live] == 0).all()
    assert (seen[:, nv:] == 0).all()
    return d_emb, live


def _replay_dp(coeff, emb, nv, blocks):
    """dP from the tiled dP kernel's schedule: one [OWN_ROWS, D] partial
    per working block, then each row's chunks in chunk order; checks that
    each (pixel, valid prototype) pair is covered once."""
    (n, d), p = emb.shape, coeff.shape[1]
    own_rows, stream_rows = fused.OWN_ROWS, fused.STREAM_ROWS
    assert blocks >= -(-p // own_rows)
    chunks, proto_blocks = fused.grad_proto_tiles(n, nv, blocks)
    seen = torch.zeros(n, p, dtype=torch.int64)
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
    return d_protos


_NV = pytest.mark.parametrize("nv", [0, 1, 70, N_PROTO],
                              ids=["none_valid", "one_valid", "70_valid",
                                   "all_valid"])
_BLOCKS = pytest.mark.parametrize("blocks", [None, 5],
                                  ids=["wrapper_grid", "five_blocks"])


@_BLOCKS
@_NV
@pytest.mark.parametrize("d,kappas", [(16, (6.0, 12.0)), (32, (6.0, 10.0)),
                                      (64, (6.0, 12.0))],
                         ids=["d16_square", "d32_two_exps", "d64_square"])
def test_tiles_cover_each_pair_once_and_replay_the_gradients(d, kappas, nv,
                                                             blocks):
    n, p = N_PIX, N_PROTO
    blocks = fused.dp_blocks(p) if blocks is None else blocks
    case = _case(n, p, nv, d, seed=d + nv)
    coeff = _coeff(case, *kappas)
    d_emb, live = _replay_de(coeff, case["protos"], nv, case["grads"])
    assert live.all()  # randn cotangents: every warp takes part
    d_protos = _replay_dp(coeff, case["emb"], nv, blocks)

    want_emb, want_protos = _reference(case, _joint_stats, *kappas)
    torch.testing.assert_close(d_emb, want_emb, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(d_protos, want_protos, rtol=1e-10, atol=1e-12)
    assert (d_protos[nv:] == 0).all()


def _stats_terms(family, case, kappas):
    """[NS, N, P]: each pair's similarity under each statistic's mask, the
    rows of the kernel's add_pair (JOINT: own, same, diff label at kappa_a,
    own, tags intersect, disjoint at kappa_o; HARD: own, same, diff label
    at kappa; SET: own, intersect, disjoint at kappa)."""
    logits = case["emb"] @ case["protos"].T
    s_a = torch.exp(kappas[0] * logits)
    own, live = fused._own_mask(case["own_idx"], case["protos"].shape[0],
                                case["num_valid"])
    same_o, diff_o = fused._tag_masks(case["pix_tags"], case["proto_tags"],
                                      case["proto_valid"], live)
    if family == "set":
        pairs = ((own, s_a), (same_o, s_a), (diff_o, s_a))
    elif family == "hard":
        own, same, diff, _ = fused._label_masks(
            case["pix_lab"], case["own_idx"], case["proto_lab"],
            case["num_valid"])
        pairs = ((own, s_a), (same, s_a), (diff, s_a))
    else:
        kappa_a, kappa_o = kappas
        _, same_a, diff_a, _ = fused._label_masks(
            case["pix_lab"], case["own_idx"], case["proto_lab"],
            case["num_valid"])
        s_o = s_a * s_a if kappa_o == 2 * kappa_a else torch.exp(
            kappa_o * logits)
        pairs = ((own, s_a), (same_a, s_a), (diff_a, s_a), (own, s_o),
                 (same_o, s_o), (diff_o, s_o))
    return torch.stack([torch.where(m, s, 0.0) for m, s in pairs])


@_NV
@pytest.mark.parametrize(
    "family,d,kappas",
    [("joint", 16, (6.0, 12.0)), ("joint", 32, (6.0, 10.0)),
     ("joint", 64, (6.0, 12.0)), ("set", 16, (8.0,)), ("set", 32, (8.0,)),
     ("set", 64, (8.0,)), ("hard", 16, (6.0,)), ("hard", 32, (6.0,)),
     ("hard", 64, (6.0,))],
    ids=["d16_square", "d32_two_exps", "d64_square", "set_d16", "set_d32",
         "set_d64", "hard_d16", "hard_d32", "hard_d64"])
def test_stats_tiles_cover_each_pair_once_and_replay_the_stats(family, d,
                                                               kappas, nv):
    """K1 (JOINT), K4 (HARD) and K7 (SET): each block's quads add their
    lanes' rows of each prototype tile into per-tile partial sums, then
    running sums in loop order, then the quad's four sums in quad_sum's
    order; rows past num_valid are never read (70 valid rows end the
    second tile inside an 8-row n tile)."""
    n, p = N_PIX, N_PROTO
    seed = d + nv + {"joint": 1, "set": 5, "hard": 8}[family]
    case = _case(n, p, nv, d, seed=seed)
    terms = _stats_terms(family, case, kappas)
    ns = terms.shape[0]

    seen = torch.zeros(n, p, dtype=torch.int64)
    stats = torch.full((ns, n), float("nan"), dtype=torch.float64)
    blocks = fused.stats_tiles(n, nv)
    assert len(blocks) == -(-n // fused.OWN_ROWS)
    for pix, ptiles in blocks:
        assert _tile_rows(pix, fused.OWN_ROWS) and pix.stop <= n
        lanes = [torch.zeros(ns, len(pix), dtype=torch.float64)
                 for _ in range(4)]
        for tile_lanes in ptiles:
            assert sorted(r for rows in tile_lanes for r in rows) == \
                list(range(tile_lanes[0][0], tile_lanes[0][0] + sum(
                    map(len, tile_lanes))))
            for t, rows in enumerate(tile_lanes):
                assert all(r < nv for r in rows)
                part = torch.zeros(ns, len(pix), dtype=torch.float64)
                for r in rows:
                    seen[pix.start:pix.stop, r] += 1
                    part += terms[:, pix.start:pix.stop, r]
                lanes[t] += part
        assert torch.isnan(stats[:, pix.start:pix.stop]).all()
        stats[:, pix.start:pix.stop] = fused.quad_sum(lanes)
    assert (seen[:, :nv] == 1).all() and (seen[:, nv:] == 0).all()

    plain = {"joint": _joint_stats, "hard": _hard_stats,
             "set": _set_stats}[family]
    want = plain(case, case["emb"], case["protos"], *kappas)
    torch.testing.assert_close(stats, want, rtol=1e-10, atol=0.0)
    if nv == 0:
        assert (stats == 0).all()


@_BLOCKS
@_NV
@pytest.mark.parametrize("d,kappa", [(16, 8.0), (32, 8.0), (64, 8.0)],
                         ids=["d16", "d32", "d64"])
def test_set_dp_tiles_replay_the_gradient(d, kappa, nv, blocks):
    """K9, the tag-set dP, on the same tiled dP kernel as K3: the replay
    of its schedule against the autograd of set_segsort_stats_reference."""
    n, p = N_PIX, N_PROTO
    blocks = fused.dp_blocks(p) if blocks is None else blocks
    case = _case(n, p, nv, d, seed=d + nv + 2)
    case["grads"] = case["grads"][:3]
    d_protos = _replay_dp(_set_coeff(case, kappa), case["emb"], nv, blocks)
    _, want = _reference(case, _set_stats, kappa)
    torch.testing.assert_close(d_protos, want, rtol=1e-10, atol=1e-12)
    assert (d_protos[nv:] == 0).all()


@_BLOCKS
@_NV
@pytest.mark.parametrize("d", [16, 32, 64], ids=["d16", "d32", "d64"])
def test_hard_dp_tiles_replay_the_gradient(d, nv, blocks):
    """K6, the hard-label dP, on the tiled dP kernel: the replay of its
    schedule against the autograd of segsort_stats_reference."""
    n, p = N_PIX, N_PROTO
    blocks = fused.dp_blocks(p) if blocks is None else blocks
    case = _case(n, p, nv, d, seed=d + nv + 3)
    case["grads"] = case["grads"][:3]
    d_protos = _replay_dp(_hard_coeff(case, 6.0), case["emb"], nv, blocks)
    _, want = _reference(case, _hard_stats, 6.0)
    torch.testing.assert_close(d_protos, want, rtol=1e-10, atol=1e-12)
    assert (d_protos[nv:] == 0).all()


@_NV
@pytest.mark.parametrize("d", [16, 32, 64], ids=["d16", "d32", "d64"])
def test_set_de_tiles_replay_the_gradient(d, nv):
    """K8, the tag-set dE, on the tiled dE kernel as K2: the replay of its
    schedule against the autograd of set_segsort_stats_reference."""
    n, p = N_PIX, N_PROTO
    case = _case(n, p, nv, d, seed=d + nv + 4)
    case["grads"] = case["grads"][:3]
    d_emb, _ = _replay_de(_set_coeff(case, 8.0), case["protos"], nv,
                          case["grads"])
    want, _ = _reference(case, _set_stats, 8.0)
    torch.testing.assert_close(d_emb, want, rtol=1e-10, atol=1e-12)


@_NV
@pytest.mark.parametrize("d", [16, 32, 64], ids=["d16", "d32", "d64"])
def test_hard_de_tiles_replay_the_gradient(d, nv):
    """K5, the hard-label dE, on the tiled dE kernel as K2 and K8: the
    replay of its schedule against the autograd of
    segsort_stats_reference."""
    n, p = N_PIX, N_PROTO
    case = _case(n, p, nv, d, seed=d + nv + 6)
    case["grads"] = case["grads"][:3]
    d_emb, _ = _replay_de(_hard_coeff(case, 6.0), case["protos"], nv,
                          case["grads"])
    want, _ = _reference(case, _hard_stats, 6.0)
    torch.testing.assert_close(d_emb, want, rtol=1e-10, atol=1e-12)


# pixel rows with a nonzero cotangent; on the others it is 0 or -0
_CARRYING = {
    # warps 0, 1 and 2 of block 0 (a run across a warp boundary); block 1
    # holds none and walks no tile
    "short_runs": [30, 31, 32, 70, 71],
    "all_zero": [],
    # warp 2 of block 1 (rows 192-199, the ragged end); block 0 holds none
    "last_ragged_row": [N_PIX - 1],
}


@_NV
@pytest.mark.parametrize("carrying", list(_CARRYING))
@pytest.mark.parametrize("family", ["joint", "hard", "set"])
def test_de_skips_rows_without_cotangents(family, carrying, nv):
    """The dE kernel's skip (K2, K5, K8): the mirror names as live exactly
    the warps holding a row with a nonzero cotangent, and as walking tiles
    exactly the blocks holding a live warp; the replay agrees with the
    plain version's autograd, and every row of a skipped warp is exactly 0
    in both."""
    n, p, d = N_PIX, N_PROTO, 32
    case = _case(n, p, nv, d, seed=nv + 7)
    rows = torch.tensor(_CARRYING[carrying], dtype=torch.int64)
    carries = torch.zeros(n, dtype=torch.bool)
    carries[rows] = True
    zero = torch.zeros(n, dtype=torch.float64)
    zero[::2] = -0.0
    ns = 6 if family == "joint" else 3
    case["grads"] = torch.where(carries, case["grads"][:ns], zero)
    coeff_fn, stats, kappas = {
        "joint": (_coeff, _joint_stats, (6.0, 12.0)),
        "hard": (_hard_coeff, _hard_stats, (6.0,)),
        "set": (_set_coeff, _set_stats, (8.0,))}[family]
    coeff = coeff_fn(case, *kappas)

    w = fused.WARP_ROWS
    want_warps = [range(r, min(r + w, n)) for r in range(0, n, w)
                  if carries[r:r + w].any()]
    tiles = fused.grad_emb_tiles(n, nv, case["grads"])
    assert [wr for _, warps, _ in tiles for wr in warps] == want_warps
    for pix, warps, ptiles in tiles:
        walks = bool(carries[pix.start:pix.stop].any()) and nv > 0
        assert bool(ptiles) == walks

    d_emb, live = _replay_de(coeff, case["protos"], nv, case["grads"])
    want, _ = _reference(case, stats, *kappas)
    torch.testing.assert_close(d_emb, want, rtol=1e-10, atol=1e-12)
    assert (d_emb[~live] == 0).all() and (want[~live] == 0).all()
    assert live[carries].all()


def test_flagship_split():
    """At the flagship's shapes (N = 131072, P = 6144, ~1195 valid rows)
    the 264 blocks of the dP grid become 10 prototype tiles x 26 chunks
    of 78 or 79 pixel tiles: 260 blocks at work, a 8.65 MB scratch."""
    n, p, nv = 131072, 6144, 1195
    blocks = fused.dp_blocks(p)
    assert blocks == 264
    chunks, work = fused.grad_proto_tiles(n, nv, blocks)
    assert chunks == 26 and len(work) == 10 * 26
    assert {len(ptiles) for _, _, ptiles in work} == {78, 79}
    assert sum(len(ptiles) for _, _, ptiles in work) == \
        10 * n // fused.STREAM_ROWS
    assert blocks * fused.OWN_ROWS * 64 * 4 == 8650752
    # a grid smaller than the prototype tiles is refused by the C side;
    # the wrapper's grid is never that small
    assert fused.dp_blocks(100 * fused.OWN_ROWS) == 264
    assert fused.dp_blocks(300 * fused.OWN_ROWS + 1) == 301


def test_tag_step_split():
    """At the tag step's shapes (N = 65536, P = 3072, ~620 valid rows)
    K9's 264 blocks become 5 prototype tiles x 52 chunks of 19 or 20
    pixel tiles, over the same 8.65 MB scratch as the flagship's dP
    (the per-row kernel's was [32, 3072, 64], 25.2 MB)."""
    n, p, nv = 65536, 3072, 620
    blocks = fused.dp_blocks(p)
    chunks, work = fused.grad_proto_tiles(n, nv, blocks)
    assert chunks == 52 and len(work) == 5 * 52
    assert {len(ptiles) for _, _, ptiles in work} == {19, 20}
    assert blocks * fused.OWN_ROWS * 64 * 4 == 8650752


def test_densepose_split():
    """At the DensePose point shapes (N = 65536, P = 2048, D = 32, ~139
    valid rows) K6's 264 blocks become 2 prototype tiles x 132 chunks of 7
    or 8 pixel tiles, all at work; the second tile holds 11 live rows
    (warp 0's), and the scratch is [264, 128, 32], 4.33 MB (the per-row
    kernel's was [32, 2048, 32], 8.39 MB)."""
    n, p, nv = 65536, 2048, 139
    blocks = fused.dp_blocks(p)
    chunks, work = fused.grad_proto_tiles(n, nv, blocks)
    assert chunks == 132 and len(work) == 2 * 132 == blocks
    assert {len(ptiles) for _, _, ptiles in work} == {7, 8}
    assert {own for _, own, _ in work} == {range(0, 128), range(128, 139)}
    assert blocks * fused.OWN_ROWS * 32 * 4 == 4325376
