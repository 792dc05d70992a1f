"""Port parity on the CPU: spml_tpu_torch.ops.{common,losses,knn,kmeans}
against the JAX functions on the same numpy inputs.

Tolerances: float32 values rtol 1e-5 / atol 1e-6 (the two frameworks sum
in different orders); gradients rtol 1e-4 / atol 1e-6 (backward sums
compound the reordering); integer outputs (labels, segment ids, validity)
exactly equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.ops import common as jcommon
from spml_tpu.ops import kmeans as jkmeans
from spml_tpu.ops import knn as jknn
from spml_tpu.ops import losses as jlosses
from spml_tpu_torch.ops import common, kmeans, knn, losses
from tests import oracles

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_normalize_embedding_values_and_zero_row_gradient():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6, 16).astype(np.float32)
    x[1, 2] = 0.0  # all-zero row: value 0, finite gradient
    w = rng.randn(4, 6, 16).astype(np.float32)
    np.testing.assert_allclose(
        common.normalize_embedding(_t(x)).numpy(),
        np.asarray(jcommon.normalize_embedding(jnp.asarray(x))), **F32)

    xt = _t(x).requires_grad_(True)
    (common.normalize_embedding(xt) * _t(w)).sum().backward()
    gj = jax.grad(lambda v: jnp.sum(jcommon.normalize_embedding(v) * w))(
        jnp.asarray(x))
    assert np.all(np.isfinite(xt.grad.numpy()))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), **GRAD)


def test_one_hot_and_segment_reductions():
    rng = np.random.RandomState(1)
    vals = rng.randn(50, 5).astype(np.float32)
    ids = rng.randint(-1, 9, 50)  # -1 and 8 are out of range for 8
    wts = (rng.rand(50) > 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        common.one_hot(_t(ids), 8).numpy(),
        np.asarray(jcommon.one_hot(jnp.asarray(ids), 8)))
    np.testing.assert_allclose(
        common.segment_sum(_t(vals), _t(ids), 8, _t(wts)).numpy(),
        np.asarray(jcommon.segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                       8, jnp.asarray(wts))), **F32)
    np.testing.assert_allclose(
        common.segment_mean(_t(vals), _t(ids), 8, _t(wts)).numpy(),
        np.asarray(jcommon.segment_mean(jnp.asarray(vals),
                                        jnp.asarray(ids), 8,
                                        jnp.asarray(wts))), **F32)


@pytest.mark.parametrize("size", [(5, 7), (32, 40), (13, 17)])
def test_resize_labels_exact(size):
    rng = np.random.RandomState(2)
    lab = rng.randint(0, 255, (2, 13, 17)).astype(np.int32)
    np.testing.assert_array_equal(
        common.resize_labels(_t(lab), size).numpy(),
        np.asarray(jcommon.resize_labels(jnp.asarray(lab), size)))


def test_location_features():
    np.testing.assert_allclose(
        common.generate_location_features(9, 14).numpy(),
        np.asarray(jcommon.generate_location_features(9, 14)), **F32)


def _loss_problem(rng, n=120, p=24, d=16, c=5, t=6):
    emb = oracles.normalize(rng.randn(n, d)).astype(np.float32)
    protos = oracles.normalize(rng.randn(p, d)).astype(np.float32)
    proto_sem = rng.randint(0, c + 2, p).astype(np.int32)
    own = rng.randint(0, p, n).astype(np.int32)
    sem = proto_sem[own]
    pmask = rng.rand(n) > 0.2
    pvalid = rng.rand(p) > 0.2
    proto_tags = (rng.rand(p, t) > 0.5).astype(np.int32)
    tags = proto_tags[own]
    return emb, protos, proto_sem, own, sem, pmask, pvalid, proto_tags, tags


@pytest.mark.parametrize("kind", ["segsort", "set_segsort"])
def test_dense_losses_values_and_gradients(kind):
    rng = np.random.RandomState(3)
    emb, protos, psem, own, sem, pmask, pvalid, ptags, tags = \
        _loss_problem(rng)
    if kind == "segsort":
        lab, plab, kappa = sem, psem, 6.0
        jfn, tfn = jlosses.segsort_loss, losses.segsort_loss
    else:
        lab, plab, kappa = tags, ptags, 12.0
        jfn, tfn = jlosses.set_segsort_loss, losses.set_segsort_loss

    def jloss(e, p_, reduction="mean"):
        return jfn(e, jnp.asarray(lab), jnp.asarray(own), p_,
                   jnp.asarray(plab), kappa, jnp.asarray(pmask),
                   jnp.asarray(pvalid), reduction=reduction)

    def tloss(e, p_, reduction="mean"):
        return tfn(e, _t(lab), _t(own).long(), p_, _t(plab), kappa,
                   _t(pmask), _t(pvalid), reduction=reduction)

    np.testing.assert_allclose(
        tloss(_t(emb), _t(protos), "none").numpy(),
        np.asarray(jloss(jnp.asarray(emb), jnp.asarray(protos), "none")),
        **F32)
    e = _t(emb).requires_grad_(True)
    p = _t(protos).requires_grad_(True)
    val = tloss(e, p)
    val.backward()
    jval, (ge, gp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(emb), jnp.asarray(protos))
    np.testing.assert_allclose(float(val.detach()), float(jval), **F32)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), **GRAD)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), **GRAD)


def test_batched_segsort_loss_equals_per_image():
    """The port's leading batch axis == the JAX vmap the step uses for
    img_sim."""
    rng = np.random.RandomState(4)
    probs = [_loss_problem(rng, n=64, p=16) for _ in range(3)]
    stack = [np.stack(a) for a in zip(*probs)]
    emb, protos, psem, own, sem, pmask, pvalid = stack[:7]
    got = losses.segsort_loss(_t(emb), _t(sem), _t(own).long(), _t(protos),
                              _t(psem), 16.0, _t(pmask), _t(pvalid))
    want = jax.vmap(lambda *a: jlosses.segsort_loss(
        a[0], a[1], a[2], a[3], a[4], 16.0, a[5], a[6]))(
        *[jnp.asarray(a) for a in (emb, sem, own, protos, psem, pmask,
                                   pvalid)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# case -> (k, queries, base prototypes, times the base is repeated, mask):
# the repeats put exact ties where the card's kernel would cut the bank
# into tiles and chunks; "few" leaves fewer valid prototypes than k; "nan
# rows" makes a query and three prototypes NaN, whose scores rank first
TOP_K_CASES = {
    "k5 ties": (5, 14, 10, None, "random"),
    "k1": (1, 9, 40, 1, "random"),
    "k5 repeated bank": (5, 12, 7, 9, "random"),
    "k20": (20, 30, 64, 1, "random"),
    "k20 repeated bank": (20, 16, 5, 12, "random"),
    "p below k": (20, 6, 11, 1, "random"),
    "fewer valid than k": (20, 10, 50, 1, "few"),
    "all masked": (5, 8, 30, 1, "none"),
    "nan rows": (20, 10, 40, 1, "random"),
}


@pytest.mark.parametrize("case", list(TOP_K_CASES))
def test_top_k_ranking_with_ties_and_masks(case):
    k, n, base, repeat, mask = TOP_K_CASES[case]
    rng = np.random.RandomState(5)
    if repeat is None:  # the first ten, then four of them again
        protos = oracles.normalize(rng.randn(base, 8)).astype(np.float32)
        protos = np.concatenate([protos, protos[:4]])  # exact ties
    else:
        protos = oracles.normalize(rng.randn(base, 8)).astype(np.float32)
        protos = np.tile(protos, (repeat, 1))
    p = protos.shape[0]
    queries = (protos[:n] if repeat is None else
               oracles.normalize(rng.randn(n, 8)).astype(np.float32))
    if case == "nan rows":
        queries[1] = np.nan
        protos[[0, p // 2, p - 1]] = np.nan
    labels = rng.randint(0, 4, p).astype(np.int32)
    qlabels = labels[:n] if n <= p else rng.randint(0, 4, n).astype(np.int32)
    qmask = rng.rand(n) > 0.2
    if mask == "random":
        pmask = rng.rand(p) > 0.3
    else:
        pmask = np.zeros(p, bool)
        if mask == "few":
            pmask[rng.choice(p, 3, replace=False)] = True
    acc, top = knn.top_k_ranking(_t(queries), _t(qlabels), _t(protos),
                                 _t(labels), k, _t(qmask), _t(pmask))
    jacc, jtop = jknn.top_k_ranking(
        jnp.asarray(queries), jnp.asarray(qlabels), jnp.asarray(protos),
        jnp.asarray(labels), k, jnp.asarray(qmask), jnp.asarray(pmask))
    assert top.shape == (n, min(k, p))
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
    np.testing.assert_allclose(float(acc), float(jacc), **F32)
    # index for index: the labels the bank index
    index = np.arange(p, dtype=np.int32)
    _, top_i = knn.top_k_ranking(_t(queries), _t(qlabels), _t(protos),
                                 _t(index), k, _t(qmask), _t(pmask))
    _, jtop_i = jknn.top_k_ranking(
        jnp.asarray(queries), jnp.asarray(qlabels), jnp.asarray(protos),
        jnp.asarray(index), k, jnp.asarray(qmask), jnp.asarray(pmask))
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))


@pytest.mark.parametrize("clusters,dims", [((3, 2), (9, 8)),
                                           ((6, 6), (128, 128)),
                                           ((2, 2), (8, 8))])
def test_initialize_cluster_labels_exact(clusters, dims):
    np.testing.assert_array_equal(
        kmeans.initialize_cluster_labels(clusters, dims).numpy(),
        np.asarray(jkmeans.initialize_cluster_labels(clusters, dims)))


def _separated(rng, b, h, w, d, k=4, noise=0.05):
    """Embeddings around k well-separated centres, so that summation
    order cannot flip an argmax."""
    centres = np.eye(d, dtype=np.float32)[:k] * 3.0
    assign = rng.randint(0, k, (b, h, w))
    return (centres[assign]
            + noise * rng.randn(b, h, w, d)).astype(np.float32)


def test_kmeans_labels_and_prototypes_exact():
    rng = np.random.RandomState(6)
    emb = oracles.normalize(_separated(rng, 1, 10, 20, 6)[0].reshape(
        200, 6)).astype(np.float32)
    init = rng.randint(0, 4, 200)
    wts = (rng.rand(200) > 0.3).astype(np.float32)
    got = kmeans.kmeans_with_initial_labels(_t(emb), _t(init), 4, 10,
                                            _t(wts))
    want = jkmeans.kmeans_with_initial_labels(
        jnp.asarray(emb), jnp.asarray(init.astype(np.int32)), 4, 10,
        jnp.asarray(wts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        kmeans.calculate_prototypes_from_labels(_t(emb), got, 4,
                                                _t(wts)).numpy(),
        np.asarray(jkmeans.calculate_prototypes_from_labels(
            jnp.asarray(emb), want, 4, jnp.asarray(wts))), **F32)


@pytest.mark.parametrize("capacity", [16, 4])
def test_compact_unique_segments_exact(capacity):
    """Includes capacity overflow (capacity 4 < 12 distinct keys)."""
    rng = np.random.RandomState(7)
    keys = rng.randint(0, 12, 64).astype(np.int32)
    valid = rng.rand(64) > 0.2
    seg, keep = kmeans.compact_unique_segments(_t(keys), _t(valid),
                                               capacity)
    jseg, jkeep = jkmeans.compact_unique_segments(
        jnp.asarray(keys), jnp.asarray(valid), capacity)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


@pytest.mark.parametrize("case", ["ignore_region", "overflow",
                                  "all_ignore_image", "single_label"])
def test_segment_batch_exact(case):
    """segment_batch == the JAX function: segment ids, pixel validity,
    segment attributes and validity equal; normalized rows close."""
    rng = np.random.RandomState(8)
    b, h, w, d = 2, 16, 16, 8
    emb = _separated(rng, b, h, w, d)
    loc = np.broadcast_to(
        np.asarray(jcommon.generate_location_features(h, w)) - 0.5,
        (b, h, w, 2)).astype(np.float32)
    sem = rng.randint(0, 3, (b, h, w)).astype(np.int32)
    inst = rng.randint(0, 2, (b, h, w)).astype(np.int32)
    clusters, capacity = (2, 2), 64
    if case == "ignore_region":
        sem[0, :4] = 255
    elif case == "overflow":
        capacity = 5
    elif case == "all_ignore_image":
        sem[1] = 255
    else:
        sem[:] = 1
        inst[:] = 0
        clusters, capacity = (3, 3), 9
    segs, emb_flat, emb_loc = kmeans.segment_batch(
        _t(emb), _t(loc), _t(sem), _t(inst), clusters, capacity, 10, 255)
    jsegs, jflat, jloc = jkmeans.segment_batch(
        jnp.asarray(emb), jnp.asarray(loc), jnp.asarray(sem),
        jnp.asarray(inst), clusters, capacity, 10, 255)
    for name in jsegs._fields:
        np.testing.assert_array_equal(getattr(segs, name).numpy(),
                                      np.asarray(getattr(jsegs, name)),
                                      err_msg=name)
    np.testing.assert_allclose(emb_flat.numpy(), np.asarray(jflat), **F32)
    np.testing.assert_allclose(emb_loc.numpy(), np.asarray(jloc), **F32)
    if case == "all_ignore_image":
        assert not segs.segment_valid[1].any()
        assert not segs.pixel_valid[1].any()
    if case == "overflow":
        assert segs.segment_valid.sum(dim=1).tolist() == [capacity] * b


@pytest.mark.parametrize("top_k", [1, 3])
def test_nearest_neighbor_multiset_labels_exact(top_k):
    """The DensePose NN-propagated tags, as the step calls them
    (prototypes against themselves, plus near copies above the 0.95
    threshold): equal to the JAX function, including image 2, which has
    no allowed prototype (all rows zero), and labels >= num_classes."""
    rng = np.random.RandomState(9)
    c, p = 5, 30
    protos = oracles.normalize(rng.randn(p, 7))
    near = oracles.normalize(protos[:10] + 0.1 * rng.randn(10, 7))
    emb = np.concatenate([protos, near]).astype(np.float32)
    protos = protos.astype(np.float32)
    plab = rng.randint(0, c + 2, p).astype(np.int32)
    pbatch = rng.randint(0, 2, p).astype(np.int32)
    pbatch[-4:] = 2
    plab[-4:] = c + 1  # image 2: unlabelled prototypes only
    ebatch = np.concatenate([pbatch, pbatch[:10]])
    pmask = rng.rand(p) > 0.2
    got = knn.nearest_neighbor_multiset_labels(
        _t(emb), _t(protos), _t(plab), _t(ebatch), _t(pbatch), c,
        top_k=top_k, threshold=0.95, prototype_mask=_t(pmask))
    want = jknn.nearest_neighbor_multiset_labels(
        jnp.asarray(emb), jnp.asarray(protos), jnp.asarray(plab),
        jnp.asarray(ebatch), jnp.asarray(pbatch), c, top_k=top_k,
        threshold=0.95, prototype_mask=jnp.asarray(pmask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (40, c)
    assert not got[ebatch == 2].any() and got.sum() > 0
