"""The bf16-operand form of the port's fused SegSort losses
(tpu.loss_operand_dtype = "bfloat16") on the CPU, where a CPU tensor takes
the plain version: the embeddings and prototypes rounded to bf16 inside
the autograd.Function, the gradients' coefficient c rounded to bf16 before
c P and c^T E, float32 sums and float32 cotangents out.

* each family (hard labels, tag sets, joint in both kappa branches)
  against the JAX package's fused loss with operand_dtype="bfloat16" in
  interpret mode, on the numpy inputs of tests/test_torch_segsort_loss.py
  at n = 256, p = 64 (tests/test_pallas_loss.py:295-330's size);
* the bf16 form against the port's float32 form at the JAX package's own
  quantified delta (tests/test_pallas_loss.py:295-325);
* the plain backward rounds c: its gradients differ from autograd's
  through the rounded operands, by no more than c's rounding.
Two flagship train steps with the knob against JAX's are
tests/test_torch_train_step.py::test_two_bf16_train_steps_match_jax,
beside the float32 ones, whose JAX initial state they share.

Tolerances: those of tests/test_torch_segsort_loss.py (per-pixel log
likelihoods and losses rtol 1e-5; dE / dP rtol 1e-4, atol 1e-7): both
sides take the same bf16 operands and round c from float32, so they
differ only where float32 sums in another order flip a bf16 rounding of
c, which none of these inputs does (the worst element uses 0.2-14% of
the gradient tolerance).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.ops.pallas import segsort_loss as jfused
from spml_tpu_torch.ops import segsort_loss as fused
from tests.test_torch_segsort_loss import GRAD, LL, _problem, _t

# family case -> (loss, kappas, the mask of the pixels in its mean)
CASES = {"hard": ("hard", (6.0,), "ann_mask"),
         "set": ("set", (8.0,), "occ_mask"),
         "joint_square": ("joint", (6.0, 12.0), None),
         "joint_two_exps": ("joint", (6.0, 10.0), None)}


def _problem_bf16(seed):
    pb = _problem(seed, n=256, p=64, fill=0.3)
    # a third of the pixels outside the tag loss's mask
    pb["occ_mask"] = np.random.RandomState(seed + 40).rand(256) < 0.67
    return pb


def _torch_mean(ll, mask):
    m = _t(mask).float()
    return (ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def _jax_mean(ll, mask):
    m = jnp.asarray(mask, jnp.float32)
    return (ll * m).sum() / jnp.maximum(m.sum(), 1.0)


def _port(pb, case, operand_dtype="bfloat16"):
    """(per-pixel log likelihoods, loss, dE, dP) of the port."""
    family, kappas, _ = CASES[case]
    e = _t(pb["emb"]).requires_grad_(True)
    p = _t(pb["protos"]).requires_grad_(True)
    if family == "joint":
        lls = fused.fused_joint_losses(
            e, _t(pb["sem"]), _t(pb["own"]), _t(pb["tags"]), p,
            _t(pb["ann_plab"]), _t(pb["proto_tags"]), *kappas,
            _t(pb["ann_mask"]), _t(pb["occ_mask"]), _t(pb["pvalid"]),
            reduction="none", operand_dtype=operand_dtype)
        masks = (pb["ann_mask"], pb["occ_mask"])
    elif family == "hard":
        lls = (fused.fused_segsort_loss(
            e, _t(pb["sem"]), _t(pb["own"]), p, _t(pb["proto_sem"]),
            kappas[0], _t(pb["ann_mask"]),
            _t(pb["pvalid"] & (pb["proto_sem"] < pb["c"])),
            reduction="none", operand_dtype=operand_dtype),)
        masks = (pb["ann_mask"],)
    else:
        lls = (fused.fused_set_segsort_loss(
            e, _t(pb["tags"]), _t(pb["own"]), p, _t(pb["proto_tags"]),
            kappas[0], _t(pb["occ_mask"]), _t(pb["pvalid"]),
            reduction="none", operand_dtype=operand_dtype),)
        masks = (pb["occ_mask"],)
    loss = sum(w * _torch_mean(ll, m)
               for w, ll, m in zip((1.0, 0.5), lls, masks))
    loss.backward()
    return ([ll.detach().numpy() for ll in lls], float(loss.detach()), e.grad,
            p.grad)


def _jax(pb, case):
    """The same from the JAX package's bf16 kernels in interpret mode."""
    family, kappas, _ = CASES[case]

    def fn(e, p_):
        if family == "joint":
            lls = jfused.fused_joint_losses(
                e, jnp.asarray(pb["sem"]), jnp.asarray(pb["own"]),
                jnp.asarray(pb["tags"]), p_, jnp.asarray(pb["ann_plab"]),
                jnp.asarray(pb["proto_tags"]), *kappas,
                jnp.asarray(pb["ann_mask"]), jnp.asarray(pb["occ_mask"]),
                jnp.asarray(pb["pvalid"]), interpret=True,
                reduction="none", operand_dtype="bfloat16")
            masks = (pb["ann_mask"], pb["occ_mask"])
        elif family == "hard":
            lls = (jfused.fused_segsort_loss(
                e, jnp.asarray(pb["sem"]), jnp.asarray(pb["own"]), p_,
                jnp.asarray(pb["proto_sem"]), kappas[0],
                jnp.asarray(pb["ann_mask"]),
                jnp.asarray(pb["pvalid"] & (pb["proto_sem"] < pb["c"])),
                interpret=True, reduction="none",
                operand_dtype="bfloat16"),)
            masks = (pb["ann_mask"],)
        else:
            lls = (jfused.fused_set_segsort_loss(
                e, jnp.asarray(pb["tags"]), jnp.asarray(pb["own"]), p_,
                jnp.asarray(pb["proto_tags"]), kappas[0],
                jnp.asarray(pb["occ_mask"]), jnp.asarray(pb["pvalid"]),
                interpret=True, reduction="none",
                operand_dtype="bfloat16"),)
            masks = (pb["occ_mask"],)
        loss = sum(w * _jax_mean(ll, m)
                   for w, ll, m in zip((1.0, 0.5), lls, masks))
        return loss, lls

    (loss, lls), (ge, gp) = jax.value_and_grad(fn, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(pb["emb"]), jnp.asarray(pb["protos"]))
    return ([np.asarray(ll) for ll in lls], float(loss), np.asarray(ge),
            np.asarray(gp))


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_matches_jax_interpret(case):
    """Per-pixel log likelihoods (pixels in the loss), the loss, dE and
    dP against the JAX bf16 kernels; the gradients come back float32."""
    pb = _problem_bf16(list(CASES).index(case))
    lls, loss, de, dp = _port(pb, case)
    jlls, jloss, jde, jdp = _jax(pb, case)
    masks = (pb["ann_mask"], pb["occ_mask"]) if CASES[case][0] == "joint" \
        else (pb[CASES[case][2]],)
    for ll, jll, m in zip(lls, jlls, masks):
        np.testing.assert_allclose(ll[m], jll[m], **LL)
    np.testing.assert_allclose(loss, jloss, **LL)
    assert de.dtype == dp.dtype == torch.float32
    np.testing.assert_allclose(de.numpy(), jde, **GRAD)
    np.testing.assert_allclose(dp.numpy(), jdp, **GRAD)


@pytest.mark.parametrize("case", ["hard", "set", "joint_square"])
def test_bf16_close_to_float32(case):
    """The knob's quantified delta in the JAX package: the loss within
    rtol 1.5e-2 of the float32 form's and the gradients' cosine above 0.999
    (tests/test_pallas_loss.py:295-325); for the joint loss at this d = 16
    and kappa_o 12, its joint test's 0.995 and a norm ratio in (0.75, 1.3)
    (:328-360, measured there: 0.9988); and not equal (the operands are
    rounded)."""
    pb = _problem_bf16(10 + list(CASES).index(case))
    _, v16, de16, dp16 = _port(pb, case)
    _, v32, de32, dp32 = _port(pb, case, "float32")
    np.testing.assert_allclose(v16, v32, rtol=1.5e-2)
    assert v16 != v32
    joint = CASES[case][0] == "joint"
    for a, b in ((de16, de32), (dp16, dp32)):
        a, b = a.ravel().double(), b.ravel().double()
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos > (0.995 if joint else 0.999), cos
        if joint:
            assert 0.75 < float(a.norm() / b.norm()) < 1.3


@pytest.mark.parametrize("family", ["joint", "hard", "set"])
def test_plain_backward_rounds_c(family):
    """_PlainBf16's gradients against autograd's through the same rounded
    operands (c unrounded), in float64: they differ (c is rounded), by no
    more than bf16_rounding_spread at 2^-7 of c's terms (at least one bf16
    unit of each c)."""
    rng = np.random.RandomState(20)
    pb = _problem_bf16(20)
    e64 = _t(pb["emb"]).double()
    p64 = _t(pb["protos"]).double()
    nv = torch.tensor([40])
    ints = {"joint": [_t(pb["sem"]), _t(pb["own"]),
                      fused._pack_tag_bits(_t(pb["tags"]))],
            "hard": [_t(pb["sem"]), _t(pb["own"])],
            "set": [fused._pack_tag_bits(_t(pb["tags"])), _t(pb["own"])]}
    pints = {"joint": [_t(pb["ann_plab"]),
                       fused._pack_tag_bits(_t(pb["proto_tags"])),
                       _t(pb["pvalid"].astype(np.int32))],
             "hard": [_t(pb["ann_plab"])],
             "set": [fused._pack_tag_bits(_t(pb["proto_tags"])),
                     _t(pb["pvalid"].astype(np.int32))]}
    kappas = (6.0, 12.0) if family == "joint" else (8.0,)
    ns = 6 if family == "joint" else 3
    grads = torch.from_numpy(rng.randn(ns, 256))
    plain = {"joint": fused.joint_segsort_stats_reference,
             "hard": fused.segsort_stats_reference,
             "set": fused.set_segsort_stats_reference}[family]
    got = []
    for dtype in ("bfloat16", None):
        e = (e64 if dtype else fused.round_bf16(e64)).requires_grad_(True)
        p = (p64 if dtype else fused.round_bf16(p64)).requires_grad_(True)
        s = plain(e, *ints[family], p, *pints[family], nv, *kappas,
                  **({"operand_dtype": dtype} if dtype else {}))
        got.append(torch.autograd.grad((s * grads).sum(), (e, p)))
    args = [e64, *ints[family], p64, *pints[family], nv, *kappas]
    bound = fused.bf16_rounding_spread(family, args, grads, rel=2.0 ** -7)
    for (rounded, exact, limit) in zip(got[0], got[1], bound):
        diff = (rounded - exact).abs()
        assert diff.max() > 0
        assert (diff <= limit + 1e-12).all()
