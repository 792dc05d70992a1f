"""The port's fused SegSort losses on the CPU (the plain versions the
CUDA kernels are held against): the joint family vs the JAX fused joint
loss in interpret mode, the hard-label family vs the JAX fused_segsort_loss
in interpret mode, and both vs the dense losses.

Tolerances: per-pixel log likelihoods and scalar losses rtol 1e-5 (f32,
different summation order); dE / dP rtol 1e-4, atol 1e-7 (backward sums
compound the reordering, as in tests/test_pallas_loss.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.ops import losses as jlosses
from spml_tpu.ops.pallas import segsort_loss as jfused
from spml_tpu_torch.ops import losses, segsort_loss as fused
from tests import oracles

LL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-7)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _problem(seed, n=300, p=40, d=16, c=5, t=20, fill=0.8):
    rng = np.random.RandomState(seed)
    emb = oracles.normalize(rng.randn(n, d)).astype(np.float32)
    protos = oracles.normalize(rng.randn(p, d)).astype(np.float32)
    proto_sem = rng.randint(0, c + 2, p).astype(np.int32)
    own = rng.randint(0, p, n).astype(np.int32)
    sem = proto_sem[own]
    proto_tags = (rng.rand(p, t) > 0.5).astype(np.int32)
    tags = proto_tags[own]
    pvalid = rng.rand(p) < fill
    ann_mask = sem < c
    occ_mask = np.ones(n, bool)
    ann_plab = np.where(pvalid & (proto_sem < c), proto_sem, -1).astype(
        np.int32)
    return dict(emb=emb, sem=sem, own=own, tags=tags, protos=protos,
                ann_plab=ann_plab, proto_tags=proto_tags, ann_mask=ann_mask,
                occ_mask=occ_mask, pvalid=pvalid, proto_sem=proto_sem, c=c)


def _torch_joint(pb, kappas=(6.0, 12.0), reduction="mean", compact=True):
    e = _t(pb["emb"]).requires_grad_(True)
    p = _t(pb["protos"]).requires_grad_(True)
    ann, occ = fused.fused_joint_losses(
        e, _t(pb["sem"]), _t(pb["own"]), _t(pb["tags"]), p,
        _t(pb["ann_plab"]), _t(pb["proto_tags"]), *kappas,
        _t(pb["ann_mask"]), _t(pb["occ_mask"]), _t(pb["pvalid"]),
        reduction=reduction, compact=compact)
    return e, p, ann, occ


def _jax_joint_fn(pb, kappas=(6.0, 12.0), reduction="mean", compact=True):
    def fn(e, p_):
        return jfused.fused_joint_losses(
            e, jnp.asarray(pb["sem"]), jnp.asarray(pb["own"]),
            jnp.asarray(pb["tags"]), p_, jnp.asarray(pb["ann_plab"]),
            jnp.asarray(pb["proto_tags"]), *kappas,
            jnp.asarray(pb["ann_mask"]), jnp.asarray(pb["occ_mask"]),
            jnp.asarray(pb["pvalid"]), interpret=True, reduction=reduction,
            compact=compact)
    return fn


@pytest.mark.parametrize("kappas", [(6.0, 12.0), (6.0, 10.0)],
                         ids=["square_branch", "two_exps"])
def test_joint_matches_jax_fused_interpret(kappas):
    """Per-pixel ll (masked pixels), the scalar losses and dE / dP
    against the JAX joint Pallas kernel in interpret mode, in both the
    kappa_o == 2 kappa_a branch and the other."""
    pb = _problem(0, fill=0.3)
    _, _, ann_ll, occ_ll = _torch_joint(pb, kappas, reduction="none")
    jann, jocc = _jax_joint_fn(pb, kappas, reduction="none")(
        jnp.asarray(pb["emb"]), jnp.asarray(pb["protos"]))
    m = pb["ann_mask"]
    np.testing.assert_allclose(ann_ll.detach().numpy()[m],
                               np.asarray(jann)[m], **LL)
    np.testing.assert_allclose(occ_ll.detach().numpy(), np.asarray(jocc),
                               **LL)

    e, p, ann, occ = _torch_joint(pb, kappas)
    (ann + 0.5 * occ).backward()
    jfn = _jax_joint_fn(pb, kappas)
    jval, (ge, gp) = jax.value_and_grad(
        lambda e_, p_: sum(w * v for w, v in zip((1.0, 0.5), jfn(e_, p_))),
        argnums=(0, 1))(jnp.asarray(pb["emb"]), jnp.asarray(pb["protos"]))
    np.testing.assert_allclose(float((ann + 0.5 * occ).detach()),
                               float(jval), **LL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), **GRAD)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), **GRAD)


def test_joint_matches_dense_losses():
    """The joint sweep equals the port's dense segsort + set_segsort
    losses (values and gradients)."""
    pb = _problem(1)
    e, p, ann, occ = _torch_joint(pb)
    (ann + 0.5 * occ).backward()
    e2 = _t(pb["emb"]).requires_grad_(True)
    p2 = _t(pb["protos"]).requires_grad_(True)
    c = pb["c"]
    dense_ann = losses.segsort_loss(
        e2, _t(pb["sem"]), _t(pb["own"]).long(), p2, _t(pb["proto_sem"]),
        6.0, _t(pb["ann_mask"]), _t(pb["pvalid"] & (pb["proto_sem"] < c)))
    dense_occ = losses.set_segsort_loss(
        e2, _t(pb["tags"]), _t(pb["own"]).long(), p2, _t(pb["proto_tags"]),
        12.0, _t(pb["occ_mask"]), _t(pb["pvalid"]))
    (dense_ann + 0.5 * dense_occ).backward()
    np.testing.assert_allclose(float(ann.detach()), float(dense_ann.detach()),
                               **LL)
    np.testing.assert_allclose(float(occ.detach()), float(dense_occ.detach()),
                               **LL)
    np.testing.assert_allclose(e.grad.numpy(), e2.grad.numpy(), **GRAD)
    np.testing.assert_allclose(p.grad.numpy(), p2.grad.numpy(), **GRAD)


def test_compaction_exactness_low_fill():
    """Counterpart of test_pallas_loss.py::test_compaction_exactness_low_
    fill: at ~20% scattered fill, with pixels whose own prototype is
    invalid, compaction on == off in values and gradients, and both match
    the dense JAX oracle of the ann component."""
    pb = _problem(7, n=512, p=64, fill=0.2)
    results = {}
    for compact in (True, False):
        e, p, ann, occ = _torch_joint(pb, compact=compact)
        total = ann + 0.5 * occ
        total.backward()
        results[compact] = (float(total.detach()), e.grad.numpy(),
                            p.grad.numpy(), float(ann.detach()))
    np.testing.assert_allclose(results[True][0], results[False][0],
                               rtol=1e-6)
    for a, b in zip(results[True][1:3], results[False][1:3]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)
    c = pb["c"]
    dense_ann = jlosses.segsort_loss(
        jnp.asarray(pb["emb"]), jnp.asarray(pb["sem"]),
        jnp.asarray(pb["own"]), jnp.asarray(pb["protos"]),
        jnp.asarray(pb["proto_sem"]), 6.0, jnp.asarray(pb["ann_mask"]),
        jnp.asarray(pb["pvalid"] & (pb["proto_sem"] < c)))
    np.testing.assert_allclose(results[True][3], float(dense_ann), **LL)


def test_compaction_all_invalid_is_finite():
    """num_valid == 0: every statistic is zero; the losses and their
    gradients stay finite (0 through the masked mean), not NaN."""
    rng = np.random.RandomState(8)
    n, p, d = 256, 32, 8
    e = _t(oracles.normalize(rng.randn(n, d)).astype(
        np.float32)).requires_grad_(True)
    protos = _t(oracles.normalize(rng.randn(p, d)).astype(np.float32))
    own = _t(rng.randint(0, p, n))
    ann, occ = fused.fused_joint_losses(
        e, torch.zeros(n, dtype=torch.int64), own,
        torch.ones(n, 3, dtype=torch.int64), protos,
        torch.full((p,), -1), torch.ones(p, 3, dtype=torch.int64), 6.0,
        12.0, torch.zeros(n, dtype=torch.bool),
        torch.zeros(n, dtype=torch.bool), torch.zeros(p, dtype=torch.bool))
    (ann + occ).backward()
    assert np.isfinite(float(ann.detach())) and np.isfinite(
        float(occ.detach()))
    assert torch.isfinite(e.grad).all()


def test_joint_kernel_matches_separate():
    """Counterpart of test_pallas_loss.py::test_joint_kernel_matches_
    separate: the port's joint loss equals the JAX package's two separate
    fused losses (interpret mode) in values and gradients."""
    pb = _problem(6)
    e, p, ann, occ = _torch_joint(pb)
    (ann + 0.5 * occ).backward()

    def separate_fn(e_, p_):
        a = jfused.fused_segsort_loss(
            e_, jnp.asarray(pb["sem"]), jnp.asarray(pb["own"]), p_,
            jnp.asarray(pb["ann_plab"]), 6.0, jnp.asarray(pb["ann_mask"]),
            jnp.asarray(pb["pvalid"]), interpret=True)
        o = jfused.fused_set_segsort_loss(
            e_, jnp.asarray(pb["tags"]), jnp.asarray(pb["own"]), p_,
            jnp.asarray(pb["proto_tags"]), 12.0, jnp.asarray(pb["occ_mask"]),
            jnp.asarray(pb["pvalid"]), interpret=True)
        return a + 0.5 * o

    vs, (ge, gp) = jax.value_and_grad(separate_fn, argnums=(0, 1))(
        jnp.asarray(pb["emb"]), jnp.asarray(pb["protos"]))
    np.testing.assert_allclose(float((ann + 0.5 * occ).detach()), float(vs),
                               **LL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), **GRAD)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), **GRAD)


def test_wrapper_pieces_match_jax():
    """_pack_tag_bits, _own_flag and _compact_prototypes against the JAX
    wrapper pieces (exact)."""
    rng = np.random.RandomState(9)
    tags = (rng.rand(50, 31) > 0.5).astype(np.int32)
    np.testing.assert_array_equal(
        fused._pack_tag_bits(_t(tags)).numpy(),
        np.asarray(jfused._pack_tag_bits(jnp.asarray(tags))))
    own = rng.randint(0, 20, 50)
    mask = rng.rand(50) > 0.5
    np.testing.assert_array_equal(
        fused._own_flag(_t(own), _t(mask), 20).numpy(),
        np.asarray(jfused._own_flag(jnp.asarray(own), jnp.asarray(mask),
                                    20)))
    valid = rng.rand(20) > 0.6
    arr = rng.randn(20, 3).astype(np.float32)
    (got,), got_own, got_n = fused._compact_prototypes(
        _t(valid), [_t(arr)], _t(own))
    (want,), want_own, want_n = jfused._compact_prototypes(
        jnp.asarray(valid), [jnp.asarray(arr)], jnp.asarray(own))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_own.numpy(), np.asarray(want_own))
    assert int(got_n) == int(want_n[0])


# ---------------------------------------------------------------------------
# Hard-label family (sem_ann alone: K4-K6 on the card)
# ---------------------------------------------------------------------------

def _torch_hard(pb, reduction="mean", compact=True, kappa=6.0):
    e = _t(pb["emb"]).requires_grad_(True)
    p = _t(pb["protos"]).requires_grad_(True)
    ll = fused.fused_segsort_loss(
        e, _t(pb["sem"]), _t(pb["own"]), p, _t(pb["proto_sem"]), kappa,
        _t(pb["ann_mask"]), _t(pb["pvalid"] & (pb["proto_sem"] < pb["c"])),
        reduction=reduction, compact=compact)
    return e, p, ll


def _jax_hard_fn(pb, reduction="mean", compact=True, kappa=6.0):
    def fn(e, p_):
        return jfused.fused_segsort_loss(
            e, jnp.asarray(pb["sem"]), jnp.asarray(pb["own"]), p_,
            jnp.asarray(pb["proto_sem"]), kappa, jnp.asarray(pb["ann_mask"]),
            jnp.asarray(pb["pvalid"] & (pb["proto_sem"] < pb["c"])),
            interpret=True, reduction=reduction, compact=compact)
    return fn


@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "no_compact"])
def test_hard_matches_jax_fused_interpret(compact):
    """Per-pixel ll on the masked pixels, the scalar loss and dE / dP
    against the JAX hard-label Pallas kernels in interpret mode, with and
    without the valid-first compaction."""
    pb = _problem(2, fill=0.3)
    _, _, ll = _torch_hard(pb, "none", compact)
    jll = _jax_hard_fn(pb, "none", compact)(jnp.asarray(pb["emb"]),
                                            jnp.asarray(pb["protos"]))
    m = pb["ann_mask"]
    np.testing.assert_allclose(ll.detach().numpy()[m], np.asarray(jll)[m],
                               **LL)

    e, p, val = _torch_hard(pb, compact=compact)
    val.backward()
    jval, (ge, gp) = jax.value_and_grad(_jax_hard_fn(pb, compact=compact),
                                        argnums=(0, 1))(
        jnp.asarray(pb["emb"]), jnp.asarray(pb["protos"]))
    np.testing.assert_allclose(float(val.detach()), float(jval), **LL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), **GRAD)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), **GRAD)


def test_hard_matches_dense_loss():
    """The hard-label sweep equals the port's dense losses.segsort_loss
    (values and gradients), at ~20% scattered fill."""
    pb = _problem(3, n=512, p=64, fill=0.2)
    e, p, val = _torch_hard(pb)
    val.backward()
    e2 = _t(pb["emb"]).requires_grad_(True)
    p2 = _t(pb["protos"]).requires_grad_(True)
    dense = losses.segsort_loss(
        e2, _t(pb["sem"]), _t(pb["own"]).long(), p2, _t(pb["proto_sem"]),
        6.0, _t(pb["ann_mask"]),
        _t(pb["pvalid"] & (pb["proto_sem"] < pb["c"])))
    dense.backward()
    np.testing.assert_allclose(float(val.detach()), float(dense.detach()),
                               **LL)
    np.testing.assert_allclose(e.grad.numpy(), e2.grad.numpy(), **GRAD)
    np.testing.assert_allclose(p.grad.numpy(), p2.grad.numpy(), **GRAD)


def test_hard_all_invalid_is_finite():
    """No valid prototype and no masked pixel (num_valid == 0): the
    statistics are zero, the loss and its gradients stay finite."""
    rng = np.random.RandomState(10)
    n, p, d = 256, 32, 8
    e = _t(oracles.normalize(rng.randn(n, d)).astype(
        np.float32)).requires_grad_(True)
    protos = _t(oracles.normalize(rng.randn(p, d)).astype(
        np.float32)).requires_grad_(True)
    ll = fused.fused_segsort_loss(
        e, torch.zeros(n, dtype=torch.int64), _t(rng.randint(0, p, n)),
        protos, torch.zeros(p, dtype=torch.int64), 6.0,
        torch.zeros(n, dtype=torch.bool), torch.zeros(p, dtype=torch.bool))
    ll.backward()
    assert float(ll.detach()) == 0.0
    assert torch.isfinite(e.grad).all() and torch.isfinite(protos.grad).all()


# ---------------------------------------------------------------------------
# Tag-set family (sem_occ alone: K7-K9 on the card)
# ---------------------------------------------------------------------------

def _torch_set(pb, reduction="mean", compact=True, kappa=8.0, tags=None,
               proto_tags=None):
    e = _t(pb["emb"]).requires_grad_(True)
    p = _t(pb["protos"]).requires_grad_(True)
    ll = fused.fused_set_segsort_loss(
        e, _t(pb["tags"] if tags is None else tags), _t(pb["own"]), p,
        _t(pb["proto_tags"] if proto_tags is None else proto_tags), kappa,
        _t(pb["occ_mask"]), _t(pb["pvalid"]), reduction=reduction,
        compact=compact)
    return e, p, ll


def _jax_set_fn(pb, reduction="mean", compact=True, kappa=8.0, tags=None,
                proto_tags=None):
    def fn(e, p_):
        return jfused.fused_set_segsort_loss(
            e, jnp.asarray(pb["tags"] if tags is None else tags),
            jnp.asarray(pb["own"]), p_,
            jnp.asarray(pb["proto_tags"] if proto_tags is None
                        else proto_tags), kappa,
            jnp.asarray(pb["occ_mask"]), jnp.asarray(pb["pvalid"]),
            interpret=True, reduction=reduction, compact=compact)
    return fn


def _check_set_against_jax(pb, compact, **kw):
    _, _, ll = _torch_set(pb, "none", compact, **kw)
    jll = _jax_set_fn(pb, "none", compact, **kw)(jnp.asarray(pb["emb"]),
                                                 jnp.asarray(pb["protos"]))
    m = pb["occ_mask"]
    np.testing.assert_allclose(ll.detach().numpy()[m], np.asarray(jll)[m],
                               **LL)
    e, p, val = _torch_set(pb, compact=compact, **kw)
    val.backward()
    jval, (ge, gp) = jax.value_and_grad(
        _jax_set_fn(pb, compact=compact, **kw), argnums=(0, 1))(
        jnp.asarray(pb["emb"]), jnp.asarray(pb["protos"]))
    np.testing.assert_allclose(float(val.detach()), float(jval), **LL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), **GRAD)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), **GRAD)


@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "no_compact"])
def test_set_matches_jax_fused_interpret(compact):
    """Per-pixel ll on the masked pixels, the scalar loss and dE / dP
    against the JAX SetSegSort Pallas kernels in interpret mode, with and
    without the valid-first compaction; a third of the pixels are outside
    the mask (their own prototype may lie past the valid count)."""
    pb = _problem(4, fill=0.3)
    pb["occ_mask"] = np.random.RandomState(40).rand(len(pb["own"])) < 0.67
    _check_set_against_jax(pb, compact)


def test_set_count_valued_tags_match_jax():
    """DensePose-style count tags (values 0..3, as NN propagation can
    give): the bit packing tests `!= 0`, which is the JAX kernel's float
    dot > 0 for non-negative counts."""
    pb = _problem(5, fill=0.5)
    rng = np.random.RandomState(50)
    tags = pb["tags"] * rng.randint(1, 4, pb["tags"].shape)
    proto_tags = pb["proto_tags"] * rng.randint(1, 4,
                                                pb["proto_tags"].shape)
    proto_tags[:5] = 0  # tagless prototypes: never "same"
    assert tags.max() >= 2 and proto_tags.max() >= 2
    _check_set_against_jax(pb, True, tags=tags, proto_tags=proto_tags)


def test_set_matches_dense_loss():
    """The tag-set sweep equals the port's dense losses.set_segsort_loss
    (values and gradients), at ~20% scattered fill."""
    pb = _problem(11, n=512, p=64, fill=0.2)
    e, p, val = _torch_set(pb)
    val.backward()
    e2 = _t(pb["emb"]).requires_grad_(True)
    p2 = _t(pb["protos"]).requires_grad_(True)
    dense = losses.set_segsort_loss(
        e2, _t(pb["tags"]), _t(pb["own"]).long(), p2, _t(pb["proto_tags"]),
        8.0, _t(pb["occ_mask"]), _t(pb["pvalid"]))
    dense.backward()
    np.testing.assert_allclose(float(val.detach()), float(dense.detach()),
                               **LL)
    np.testing.assert_allclose(e.grad.numpy(), e2.grad.numpy(), **GRAD)
    np.testing.assert_allclose(p.grad.numpy(), p2.grad.numpy(), **GRAD)


def test_set_all_invalid_is_finite():
    """No valid prototype and no masked pixel (num_valid == 0): the
    statistics are zero, the loss and its gradients stay finite."""
    rng = np.random.RandomState(12)
    n, p, d = 256, 32, 8
    e = _t(oracles.normalize(rng.randn(n, d)).astype(
        np.float32)).requires_grad_(True)
    protos = _t(oracles.normalize(rng.randn(p, d)).astype(
        np.float32)).requires_grad_(True)
    ll = fused.fused_set_segsort_loss(
        e, torch.ones(n, 20, dtype=torch.int64), _t(rng.randint(0, p, n)),
        protos, torch.ones(p, 20, dtype=torch.int64), 8.0,
        torch.zeros(n, dtype=torch.bool), torch.zeros(p, dtype=torch.bool))
    ll.backward()
    assert float(ll.detach()) == 0.0
    assert torch.isfinite(e.grad).all() and torch.isfinite(protos.grad).all()
