"""Fused joint SegSort loss: sem_ann (hard labels) + sem_occ (tag sets)
statistics in one sweep over pixel-prototype pairs.

Port of the joint family of spml_tpu/ops/pallas/segsort_loss.py
(``joint_segsort_stats``, ``fused_joint_losses`` and the shared wrapper
pieces). The hot op is sims = exp(kappa * E @ P^T) over [N pixels,
P prototypes] followed by masked row sums; the dense formulation
materializes the ~3 GB matrix at flagship scale. The CUDA kernels of
csrc/segsort_joint.cu stream prototype tiles instead and emit only six
[N] statistics; the backward pass recomputes the tiles (dE and dP
kernels), so peak memory is O(N + P).

Valid-prototype compaction, as in the JAX package: the prototype array is
fixed-capacity but real labels fill a fraction of it, so the wrapper
sorts prototypes valid-first (the losses are permutation-invariant; own
indices are remapped) and the kernels stop at the valid count. The sort
key is the union of the kernels' own validity tests and "is the own
prototype of some masked pixel", so rows past the count contribute
exactly zero to every statistic of a masked pixel.

Dispatch: a CUDA tensor goes to the kernels (a failed build or launch
raises); a CPU tensor goes to the plain version
``joint_segsort_stats_reference``, differentiated by autograd.
"""

from __future__ import annotations

import torch

from spml_tpu_torch.ops import _cuda

KERNEL_SOURCE = "segsort_joint"
SUPPORTED_DIMS = (16, 32, 64)
CHUNK = 2048  # pixels per partial dP sum of the dP kernel

# launches of each kernel, counted where the wrapper launches it
LAUNCHES = {"joint_stats": 0, "joint_grad_emb": 0, "joint_grad_proto": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Shared wrapper pieces
# ---------------------------------------------------------------------------

def _compact_prototypes(valid_any, proto_arrays, own_idx):
    """Sort prototypes so every row a kernel can touch comes first.

    valid_any [P] bool. Returns (sorted proto_arrays, own_idx remapped
    through the inverse permutation, valid count as a [1] int32 tensor on
    the device, so the host never waits for it).
    """
    p = valid_any.shape[0]
    order = torch.argsort((~valid_any).to(torch.int32), stable=True)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(p, device=order.device))
    sorted_arrays = [a[order] for a in proto_arrays]
    count = valid_any.sum(dtype=torch.int32).reshape(1)
    return sorted_arrays, inv[own_idx], count


def _own_flag(own_idx, pixel_mask, p):
    """[P] bool: the prototype is the own prototype of some masked pixel.
    Integer scatter-add, so the result does not depend on the order."""
    counts = torch.zeros(p, dtype=torch.int32, device=own_idx.device)
    counts.scatter_add_(0, own_idx, pixel_mask.to(torch.int32))
    return counts > 0


def _pack_tag_bits(tags):
    """[N, T] 0/1 tags -> [N] int32 bitwords (bit c = class c; T <= 32)."""
    t = tags.shape[1]
    if t > 32:
        raise ValueError(f"tag width {t} exceeds the 32-bit packing")
    bits = torch.ones((), dtype=torch.int32, device=tags.device) << \
        torch.arange(t, dtype=torch.int32, device=tags.device)
    return torch.sum((tags != 0).to(torch.int32) * bits, dim=1).to(
        torch.int32)


def _ll_from_stats(own_s, same_s, diff_s, pixel_mask, reduction="mean"):
    """The segsort+ log likelihood from the three statistics. The 1e-30
    floor keeps the (discarded) log of pixels outside the mask finite
    when their own prototype lies past the compaction count."""
    same_minus = same_s - own_s
    numerator = torch.where(same_minus > 0, same_minus, own_s)
    numerator = torch.clamp(numerator, min=1e-30)
    ll = -torch.log(numerator / (diff_s + numerator))
    if reduction == "none":
        return ll
    m = pixel_mask.float()
    return torch.sum(ll * m) / torch.clamp(torch.sum(m), min=1.0)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def joint_segsort_stats_reference(emb, pix_lab, own_idx, pix_tags, protos,
                                  proto_lab, proto_tags, proto_valid,
                                  num_valid, kappa_a, kappa_o):
    """Dense [N, P] form of the six statistics, with the kernels' masks;
    prototype rows at or past num_valid contribute nothing. Returns a
    [6, N] tensor (own_a, same_a, diff_a, own_o, same_o, diff_o)."""
    cols = torch.arange(protos.shape[0], device=emb.device)
    live = cols < num_valid.reshape(())
    logits = emb @ protos.T
    s_a = torch.exp(logits * kappa_a)
    s_o = s_a * s_a if kappa_o == 2.0 * kappa_a else torch.exp(
        logits * kappa_o)
    lab_ok = (proto_lab >= 0) & live
    same_a = (pix_lab[:, None] == proto_lab[None, :]) & lab_ok
    diff_a = (pix_lab[:, None] != proto_lab[None, :]) & lab_ok
    inter = (pix_tags[:, None] & proto_tags[None, :]) != 0
    tag_ok = (proto_valid > 0) & live
    same_o = inter & tag_ok
    diff_o = ~inter & tag_ok
    own = (own_idx[:, None] == cols[None, :]) & live

    def rowsum(mask, s):
        return torch.sum(torch.where(mask, s, 0.0), dim=1)

    return torch.stack([rowsum(own, s_a), rowsum(same_a, s_a),
                        rowsum(diff_a, s_a), rowsum(own, s_o),
                        rowsum(same_o, s_o), rowsum(diff_o, s_o)])


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _kernel_args(emb, pix_lab, own_idx, pix_tags, protos, proto_lab,
                 proto_tags, proto_valid, num_valid, kappa_a, kappa_o):
    n, d = emb.shape
    p = protos.shape[0]
    ptrs = [t.data_ptr() for t in (emb, pix_lab, own_idx, pix_tags, protos,
                                   proto_lab, proto_tags, proto_valid,
                                   num_valid)]
    square = int(kappa_o == 2.0 * kappa_a)
    return ptrs + [n, p, d, float(kappa_a), float(kappa_o), square]


def _launch_stats(inputs, kappa_a, kappa_o):
    emb = inputs[0]
    out = torch.empty((6, emb.shape[0]), dtype=torch.float32,
                      device=emb.device)
    lib = _cuda.load(KERNEL_SOURCE)
    err = lib.segsort_joint_stats(
        *_kernel_args(*inputs, kappa_a, kappa_o), out.data_ptr(),
        _cuda.stream_handle(emb.device))
    _cuda.check(err, "segsort_joint_stats")
    LAUNCHES["joint_stats"] += 1
    return out


def _launch_grad_emb(inputs, kappa_a, kappa_o, grads):
    emb = inputs[0]
    d_emb = torch.empty_like(emb)
    lib = _cuda.load(KERNEL_SOURCE)
    err = lib.segsort_joint_grad_emb(
        *_kernel_args(*inputs, kappa_a, kappa_o), grads.data_ptr(),
        d_emb.data_ptr(), _cuda.stream_handle(emb.device))
    _cuda.check(err, "segsort_joint_grad_emb")
    LAUNCHES["joint_grad_emb"] += 1
    return d_emb


def _launch_grad_proto(inputs, kappa_a, kappa_o, grads):
    emb, protos = inputs[0], inputs[4]
    n_chunks = -(-emb.shape[0] // CHUNK)
    partial = torch.empty((n_chunks, *protos.shape), dtype=torch.float32,
                          device=emb.device)
    d_protos = torch.empty_like(protos)
    lib = _cuda.load(KERNEL_SOURCE)
    err = lib.segsort_joint_grad_proto(
        *_kernel_args(*inputs, kappa_a, kappa_o), grads.data_ptr(), CHUNK,
        partial.data_ptr(), n_chunks, d_protos.data_ptr(),
        _cuda.stream_handle(emb.device))
    _cuda.check(err, "segsort_joint_grad_proto")
    LAUNCHES["joint_grad_proto"] += 1
    return d_protos


def _kernel_operand(t, dtype):
    """Contiguous, 16-byte aligned (the kernels read float4 rows)."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _JointStats(torch.autograd.Function):
    """Forward K1 (segsort_joint_stats); backward K2 (dE) and K3 (dP).
    Gradients flow to the embeddings and prototypes only."""

    @staticmethod
    def forward(ctx, emb, protos, pix_lab, own_idx, pix_tags, proto_lab,
                proto_tags, proto_valid, num_valid, kappa_a, kappa_o):
        inputs = (emb, pix_lab, own_idx, pix_tags, protos, proto_lab,
                  proto_tags, proto_valid, num_valid)
        ctx.save_for_backward(*inputs)
        ctx.kappas = (kappa_a, kappa_o)
        return _launch_stats(inputs, kappa_a, kappa_o)

    @staticmethod
    def backward(ctx, grads):
        inputs = ctx.saved_tensors
        grads = _kernel_operand(grads, torch.float32)
        d_emb = d_protos = None
        if ctx.needs_input_grad[0]:
            d_emb = _launch_grad_emb(inputs, *ctx.kappas, grads)
        if ctx.needs_input_grad[1]:
            d_protos = _launch_grad_proto(inputs, *ctx.kappas, grads)
        return (d_emb, d_protos) + (None,) * 9


def joint_segsort_stats(emb, pix_lab, own_idx, pix_tags, protos, proto_lab,
                        proto_tags, proto_valid, num_valid, kappa_a,
                        kappa_o):
    """Six statistics in one sweep: (own_a, same_a, diff_a) for the
    hard-label loss at kappa_a and (own_o, same_o, diff_o) for the tag
    loss at kappa_o, as a [6, N] float32 tensor.

    emb [N, D], protos [P, D]; pix_lab / own_idx / pix_tags [N] and
    proto_lab / proto_tags / proto_valid [P] integers, tags as bitwords;
    num_valid [1]: rows at or past it contribute nothing.
    """
    if not emb.is_cuda:
        return joint_segsort_stats_reference(
            emb.float(), pix_lab, own_idx, pix_tags, protos.float(),
            proto_lab, proto_tags, proto_valid, num_valid, kappa_a, kappa_o)
    d = emb.shape[1]
    if d not in SUPPORTED_DIMS:
        raise ValueError(f"embedding width {d} not in {SUPPORTED_DIMS}")
    if emb.shape[0] >= 2**31 or protos.shape[0] * d >= 2**31:
        raise ValueError("joint SegSort kernels take int32 sizes")
    i32 = [_kernel_operand(t, torch.int32) for t in
           (pix_lab, own_idx, pix_tags, proto_lab, proto_tags, proto_valid,
            num_valid)]
    return _JointStats.apply(
        _kernel_operand(emb, torch.float32),
        _kernel_operand(protos, torch.float32), *i32, float(kappa_a),
        float(kappa_o))


def fused_joint_losses(embeddings, semantic_labels, own_segment_ids,
                       semantic_tags, prototypes, prototype_labels,
                       prototype_tags, kappa_ann, kappa_occ, ann_pixel_mask,
                       occ_pixel_mask, prototype_mask, reduction="mean",
                       compact=True):
    """(sem_ann, sem_occ) masked-mean losses in one fused sweep, or the
    per-pixel [N] log-likelihood pair with reduction="none".

    prototype_labels must already be -1 for prototypes excluded from the
    hard-label loss; prototype_mask gates the tag loss. Tag sets [N, T] /
    [P, T] (T <= 32) are packed to bitwords inside.
    """
    p0 = prototypes.shape[0]
    protos = prototypes.float()
    plab = prototype_labels.long()
    qtags = _pack_tag_bits(prototype_tags)
    pvalid = prototype_mask.to(torch.int32)
    own = own_segment_ids.long()
    if compact:
        touch = ((plab >= 0) | (pvalid > 0)
                 | _own_flag(own, ann_pixel_mask | occ_pixel_mask, p0))
        (protos, plab, qtags, pvalid), own, num_valid = _compact_prototypes(
            touch, [protos, plab, qtags, pvalid], own)
    else:
        num_valid = torch.full((1,), p0, dtype=torch.int32,
                               device=protos.device)
    stats = joint_segsort_stats(
        embeddings.float(), semantic_labels.long(), own,
        _pack_tag_bits(semantic_tags), protos, plab, qtags, pvalid,
        num_valid, float(kappa_ann), float(kappa_occ))
    own_a, same_a, diff_a, own_o, same_o, diff_o = stats.unbind(0)
    ann = _ll_from_stats(own_a, same_a, diff_a, ann_pixel_mask, reduction)
    occ = _ll_from_stats(own_o, same_o, diff_o, occ_pixel_mask, reduction)
    return ann, occ
