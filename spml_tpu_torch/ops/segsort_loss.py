"""Fused SegSort losses: the pixel-to-prototype statistics in one sweep.

Port of spml_tpu/ops/pallas/segsort_loss.py, three families:

* hard labels (``segsort_stats`` / ``fused_segsort_loss``): the sem_ann
  loss alone, three statistics (own, same, diff) at one concentration;
* tag sets (``set_segsort_stats`` / ``fused_set_segsort_loss``): the
  sem_occ loss alone, three statistics where same / diff mean the tag
  sets intersect / are disjoint, at one concentration;
* joint (``joint_segsort_stats`` / ``fused_joint_losses``): sem_ann (hard
  labels) + sem_occ (tag sets) together, six statistics at two
  concentrations.

The hot op is sims = exp(kappa * E @ P^T) over [N pixels, P prototypes]
followed by masked row sums; the dense formulation materializes the ~3 GB
matrix at flagship scale. The CUDA kernels of csrc/segsort_joint.cu
stream prototype tiles instead and emit only the [N] statistics; the
backward pass recomputes the tiles (dE and dP kernels), so peak memory is
O(N + P).

Valid-prototype compaction, as in the JAX package: the prototype array is
fixed-capacity but real labels fill a fraction of it, so the wrapper
sorts prototypes valid-first (the losses are permutation-invariant; own
indices are remapped) and the kernels stop at the valid count. The sort
key is the union of the kernels' own validity tests and "is the own
prototype of some masked pixel", so rows past the count contribute
exactly zero to every statistic of a masked pixel.

Dispatch: a CUDA tensor goes to the kernels (a failed build or launch
raises); a CPU tensor goes to the plain version
(``*_stats_reference``),
differentiated by autograd.
"""

from __future__ import annotations

import torch

from spml_tpu_torch.ops import _cuda

KERNEL_SOURCE = "segsort_joint"
SUPPORTED_DIMS = (16, 32, 64)
# the tiled kernels (every family's stats, dE and dP): a block owns
# OWN_ROWS rows of one side (pixels for stats and dE, valid
# prototypes for dP), WARP_ROWS to each of its four warps, and walks
# STREAM_ROWS-row tiles of the other
OWN_ROWS, STREAM_ROWS, WARP_ROWS = 128, 64, 32
# grid of the tiled dP kernel: 2 blocks per SM of a 132-SM H100, split on
# the device into valid prototype tiles x equal pixel chunks
DP_BLOCKS = 264

# family -> (statistics per pixel, position of the prototypes among the
# kernel inputs, which are in the C functions' argument order)
_FAMILIES = {"joint": (6, 4), "hard": (3, 3), "set": (3, 3)}

# launches of each kernel, counted where the wrapper launches it
LAUNCHES = {f"{family}_{kind}": 0 for family in _FAMILIES
            for kind in ("stats", "grad_emb", "grad_proto")}


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
# Plain versions
# ---------------------------------------------------------------------------

def _rowsum(mask, s):
    return torch.sum(torch.where(mask, s, 0.0), dim=1)


def _own_mask(own_idx, p, num_valid):
    """(own [N, P]: column == own index, gated by nothing but the
    num_valid cut; live [P]: column < num_valid)."""
    cols = torch.arange(p, device=own_idx.device)
    live = cols < num_valid.reshape(())
    return (own_idx[:, None] == cols[None, :]) & live, live


def _label_masks(pix_lab, own_idx, proto_lab, num_valid):
    """Masks of the label families: own (not gated by the label), same
    and different label (prototype label >= 0), all cut at num_valid."""
    own, live = _own_mask(own_idx, proto_lab.shape[0], num_valid)
    lab_ok = (proto_lab >= 0) & live
    same = (pix_lab[:, None] == proto_lab[None, :]) & lab_ok
    diff = (pix_lab[:, None] != proto_lab[None, :]) & lab_ok
    return own, same, diff, live


def _tag_masks(pix_tags, proto_tags, proto_valid, live):
    """(same, diff) of the tag-set losses: the bitwords intersect / are
    disjoint, on valid prototypes before the num_valid cut."""
    inter = (pix_tags[:, None] & proto_tags[None, :]) != 0
    tag_ok = (proto_valid > 0) & live
    return inter & tag_ok, ~inter & tag_ok


def segsort_stats_reference(emb, pix_lab, own_idx, protos, proto_lab,
                            num_valid, kappa):
    """Dense [N, P] form of the hard-label statistics, with the kernels'
    masks; prototype rows at or past num_valid contribute nothing.
    Returns a [3, N] tensor (own, same, diff)."""
    own, same, diff, _ = _label_masks(pix_lab, own_idx, proto_lab,
                                      num_valid)
    s = torch.exp((emb @ protos.T) * kappa)
    return torch.stack([_rowsum(own, s), _rowsum(same, s),
                        _rowsum(diff, s)])


def set_segsort_stats_reference(emb, pix_tags, own_idx, protos, proto_tags,
                                proto_valid, num_valid, kappa):
    """Dense [N, P] form of the tag-set statistics, with the kernels'
    masks: own (not gated by validity), same = the tag bitwords
    intersect, diff = they do not, both on valid prototypes; rows at or
    past num_valid contribute nothing. Returns a [3, N] tensor (own,
    same, diff)."""
    own, live = _own_mask(own_idx, protos.shape[0], num_valid)
    same, diff = _tag_masks(pix_tags, proto_tags, proto_valid, live)
    s = torch.exp((emb @ protos.T) * kappa)
    return torch.stack([_rowsum(own, s), _rowsum(same, s),
                        _rowsum(diff, s)])


def joint_segsort_stats_reference(emb, pix_lab, own_idx, pix_tags, protos,
                                  proto_lab, proto_tags, proto_valid,
                                  num_valid, kappa_a, kappa_o):
    """Dense [N, P] form of the six statistics, with the kernels' masks;
    prototype rows at or past num_valid contribute nothing. Returns a
    [6, N] tensor (own_a, same_a, diff_a, own_o, same_o, diff_o)."""
    own, same_a, diff_a, live = _label_masks(pix_lab, own_idx,
                                             proto_lab, num_valid)
    logits = emb @ protos.T
    s_a = torch.exp(logits * kappa_a)
    s_o = s_a * s_a if kappa_o == 2.0 * kappa_a else torch.exp(
        logits * kappa_o)
    same_o, diff_o = _tag_masks(pix_tags, proto_tags, proto_valid, live)
    return torch.stack([_rowsum(own, s_a), _rowsum(same_a, s_a),
                        _rowsum(diff_a, s_a), _rowsum(own, s_o),
                        _rowsum(same_o, s_o), _rowsum(diff_o, s_o)])


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _c_args(family, inputs):
    """(pointers of the inputs, n, p, d) as the C functions take them."""
    emb, protos = inputs[0], inputs[_FAMILIES[family][1]]
    ptrs = [t.data_ptr() for t in inputs]
    return ptrs + [emb.shape[0], protos.shape[0], emb.shape[1]]


def _launch(family, kind, inputs, scalars, *tail):
    """Calls segsort_{family}_{kind} on PyTorch's current stream; raises on
    a launch error and counts the launch."""
    name = f"segsort_{family}_{kind}"
    fn = getattr(_cuda.load(KERNEL_SOURCE), name)
    err = fn(*_c_args(family, inputs), *scalars, *tail,
             _cuda.stream_handle(inputs[0].device))
    _cuda.check(err, name)
    LAUNCHES[f"{family}_{kind}"] += 1


def _launch_stats(family, inputs, scalars):
    emb = inputs[0]
    out = torch.empty((_FAMILIES[family][0], emb.shape[0]),
                      dtype=torch.float32, device=emb.device)
    _launch(family, "stats", inputs, scalars, out.data_ptr())
    return out


def _launch_grad_emb(family, inputs, scalars, grads):
    d_emb = torch.empty_like(inputs[0])
    _launch(family, "grad_emb", inputs, scalars, grads.data_ptr(),
            d_emb.data_ptr())
    return d_emb


def _launch_grad_proto(family, inputs, scalars, grads):
    protos = inputs[_FAMILIES[family][1]]
    d_protos = torch.empty_like(protos)
    blocks = dp_blocks(protos.shape[0])
    partial = torch.empty((blocks, OWN_ROWS, protos.shape[1]),
                          dtype=torch.float32, device=protos.device)
    _launch(family, "grad_proto", inputs, scalars, grads.data_ptr(),
            partial.data_ptr(), blocks, d_protos.data_ptr())
    return d_protos


# ---------------------------------------------------------------------------
# The tiled kernels' schedule (csrc/segsort_joint.cu, stats_tile_kernel,
# grad_tile_kernel and reduce_tiles_kernel), mirrored for the CPU tests:
# change both together.
# ---------------------------------------------------------------------------

def dp_blocks(p):
    """Grid of the tiled dP kernel for P prototype rows (the scratch holds
    one [OWN_ROWS, D] partial per block)."""
    return max(DP_BLOCKS, -(-p // OWN_ROWS))


def _tiles(start, stop, size, count):
    """Tiles of `size` rows from start (a multiple of size) to stop, each
    cut at count."""
    return [range(t, min(t + size, count))
            for t in range(start, min(stop, count), size)]


def _pixel_blocks(n, num_valid):
    """The stats and dE kernels' walk: [(pixel rows, [prototype rows of
    each streamed tile, in loop order])], ranges cut at n and num_valid."""
    ptiles = _tiles(0, num_valid, STREAM_ROWS, num_valid)
    return [(own, ptiles) for own in _tiles(0, n, OWN_ROWS, n)]


def grad_emb_tiles(n, num_valid, grads):
    """The tiled dE kernel's blocks (every family): [(pixel rows, live
    warps' pixel rows, [prototype rows of each streamed tile, in loop
    order])]. grads [NS, N], the stats' cotangents: a warp is live if one
    of its rows carries a nonzero one (-0 counts as 0), and only live warps
    take the products; a block with no live warp walks no tile. The rows
    of the other warps are +0."""
    carries = (grads != 0).any(0).tolist()
    out = []
    for own, ptiles in _pixel_blocks(n, num_valid):
        warps = [w for w in _tiles(own.start, own.stop, WARP_ROWS, n)
                 if any(carries[r] for r in w)]
        out.append((own, warps, ptiles if warps else []))
    return out


def quad_lane_rows(tile):
    """The streamed rows of a tile that lanes t = 0..3 of a quad take, in
    each lane's order: 8 nt + 2 t + e for nt, then e, cut at the tile's
    end."""
    return [[r for nt in range(0, STREAM_ROWS, 8) for e in (0, 1)
             if (r := tile.start + nt + 2 * t + e) < tile.stop]
            for t in range(4)]


def quad_sum(lanes):
    """The stats kernel's sum of a quad's four running sums."""
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def stats_tiles(n, num_valid):
    """The tiled stats kernel's blocks (JOINT, HARD and SET): [(pixel
    rows, [quad_lane_rows of each streamed prototype tile, in loop
    order])], the dE kernel's walk with every warp live. A row's statistic
    is quad_sum of its lanes' running sums, each the tiles' partial sums
    (a lane's rows of the tile, in order) added in loop order."""
    return [(own, [quad_lane_rows(tile) for tile in ptiles])
            for own, ptiles in _pixel_blocks(n, num_valid)]


def grad_proto_tiles(n, num_valid, blocks):
    """The tiled dP kernel's split of its `blocks`: (chunks per prototype tile,
    [(block, prototype rows, [pixel rows of each streamed tile, in loop
    order])] for the blocks that write a partial). dP[k] adds, in chunk
    order c, row k % OWN_ROWS of block (k // OWN_ROWS) * chunks + c."""
    if num_valid == 0:
        return 0, []
    tiles = -(-num_valid // OWN_ROWS)
    chunks = blocks // tiles
    nt = -(-n // STREAM_ROWS)
    out = []
    for b in range(tiles * chunks):
        tile, chunk = divmod(b, chunks)
        own = _tiles(tile * OWN_ROWS, num_valid, OWN_ROWS, num_valid)[0]
        out.append((b, own, _tiles(chunk * nt // chunks * STREAM_ROWS,
                                   (chunk + 1) * nt // chunks * STREAM_ROWS,
                                   STREAM_ROWS, n)))
    return chunks, out


def _kernel_operand(t, dtype):
    """Contiguous, 16-byte aligned (the kernels read float4 rows)."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _SegsortStats(torch.autograd.Function):
    """Forward: the family's stats kernel (K1 joint, K4 hard, K7 set);
    backward: its dE (K2, K5, K8) and dP (K3, K6, K9) kernels, all tiled,
    the dE skipping the pixels whose cotangents are all zero. `inputs`
    are in the C functions' argument order; gradients flow to the
    embeddings (first) and the prototypes only."""

    @staticmethod
    def forward(ctx, family, scalars, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.family, ctx.scalars = family, scalars
        return _launch_stats(family, inputs, scalars)

    @staticmethod
    def backward(ctx, grads):
        inputs = ctx.saved_tensors
        family, scalars = ctx.family, ctx.scalars
        at = _FAMILIES[family][1]
        grads = _kernel_operand(grads, torch.float32)
        out = [None] * (2 + len(inputs))
        if ctx.needs_input_grad[2]:
            out[2] = _launch_grad_emb(family, inputs, scalars, grads)
        if ctx.needs_input_grad[2 + at]:
            out[2 + at] = _launch_grad_proto(family, inputs, scalars, grads)
        return tuple(out)


def _kernel_inputs(emb, protos, ints):
    d = emb.shape[1]
    if d not in SUPPORTED_DIMS:
        raise ValueError(f"embedding width {d} not in {SUPPORTED_DIMS}")
    if emb.shape[0] >= 2**31 or protos.shape[0] * d >= 2**31:
        raise ValueError("SegSort kernels take int32 sizes")
    return (_kernel_operand(emb, torch.float32),
            _kernel_operand(protos, torch.float32),
            [_kernel_operand(t, torch.int32) for t in ints])


def segsort_stats(emb, pix_lab, own_idx, protos, proto_lab, num_valid,
                  kappa):
    """(own, same, diff) of the hard-label loss as a [3, N] float32
    tensor.

    emb [N, D], protos [P, D]; pix_lab / own_idx [N] and proto_lab [P]
    integers, a negative prototype label excluding the prototype from
    the same / diff sums; num_valid [1]: rows at or past it contribute
    nothing.
    """
    if not emb.is_cuda:
        return segsort_stats_reference(emb.float(), pix_lab, own_idx,
                                       protos.float(), proto_lab, num_valid,
                                       kappa)
    e, p, (lab, own, plab, nv) = _kernel_inputs(
        emb, protos, (pix_lab, own_idx, proto_lab, num_valid))
    return _SegsortStats.apply("hard", (float(kappa),), e, lab, own, p,
                               plab, nv)


def set_segsort_stats(emb, pix_tags, own_idx, protos, proto_tags,
                      proto_valid, num_valid, kappa):
    """(own, same, diff) of the tag-set loss as a [3, N] float32 tensor.

    emb [N, D], protos [P, D]; pix_tags / own_idx [N] and proto_tags /
    proto_valid [P] integers, tags as bitwords; num_valid [1]: rows at or
    past it contribute nothing.
    """
    if not emb.is_cuda:
        return set_segsort_stats_reference(
            emb.float(), pix_tags, own_idx, protos.float(), proto_tags,
            proto_valid, num_valid, kappa)
    e, p, (tag, own, ptag, pval, nv) = _kernel_inputs(
        emb, protos, (pix_tags, own_idx, proto_tags, proto_valid,
                      num_valid))
    return _SegsortStats.apply("set", (float(kappa),), e, tag, own, p, ptag,
                               pval, nv)


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
    e, p, (lab, own, tag, plab, ptag, pval, nv) = _kernel_inputs(
        emb, protos, (pix_lab, own_idx, pix_tags, proto_lab, proto_tags,
                      proto_valid, num_valid))
    square = int(kappa_o == 2.0 * kappa_a)
    return _SegsortStats.apply(
        "joint", (float(kappa_a), float(kappa_o), square), e, lab, own, tag,
        p, plab, ptag, pval, nv)


def _num_valid_all(p, device):
    return torch.full((1,), p, dtype=torch.int32, device=device)


def fused_segsort_loss(embeddings, semantic_labels, own_segment_ids,
                       prototypes, prototype_semantic_labels, concentration,
                       pixel_mask, prototype_mask, reduction="mean",
                       compact=True):
    """The hard-label SegSort loss (losses.segsort_loss) in one fused
    sweep: the masked mean, or the per-pixel [N] log likelihood with
    reduction="none". Prototypes outside prototype_mask take label -1
    and drop out of the same / diff sums."""
    p0 = prototypes.shape[0]
    protos = prototypes.float()
    plab = torch.where(prototype_mask, prototype_semantic_labels.long(), -1)
    own = own_segment_ids.long()
    if compact:
        touch = (plab >= 0) | _own_flag(own, pixel_mask, p0)
        (protos, plab), own, num_valid = _compact_prototypes(
            touch, [protos, plab], own)
    else:
        num_valid = _num_valid_all(p0, protos.device)
    own_s, same_s, diff_s = segsort_stats(
        embeddings.float(), semantic_labels.long(), own, protos, plab,
        num_valid, float(concentration)).unbind(0)
    return _ll_from_stats(own_s, same_s, diff_s, pixel_mask, reduction)


def fused_set_segsort_loss(embeddings, semantic_tags, own_segment_ids,
                           prototypes, prototype_semantic_tags,
                           concentration, pixel_mask, prototype_mask,
                           reduction="mean", compact=True):
    """The tag-set SegSort loss (losses.set_segsort_loss) in one fused
    sweep: the masked mean, or the per-pixel [N] log likelihood with
    reduction="none". Tag sets [N, T] / [P, T] (T <= 32; 0/1 or counts,
    nonzero meaning present) are packed to bitwords inside; prototypes
    outside prototype_mask drop out of the same / diff sums."""
    p0 = prototypes.shape[0]
    protos = prototypes.float()
    qtags = _pack_tag_bits(prototype_semantic_tags)
    pvalid = prototype_mask.to(torch.int32)
    own = own_segment_ids.long()
    if compact:
        touch = (pvalid > 0) | _own_flag(own, pixel_mask, p0)
        (protos, qtags, pvalid), own, num_valid = _compact_prototypes(
            touch, [protos, qtags, pvalid], own)
    else:
        num_valid = _num_valid_all(p0, protos.device)
    own_s, same_s, diff_s = set_segsort_stats(
        embeddings.float(), _pack_tag_bits(semantic_tags), own, protos,
        qtags, pvalid, num_valid, float(concentration)).unbind(0)
    return _ll_from_stats(own_s, same_s, diff_s, pixel_mask, reduction)


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
        num_valid = _num_valid_all(p0, protos.device)
    stats = joint_segsort_stats(
        embeddings.float(), semantic_labels.long(), own,
        _pack_tag_bits(semantic_tags), protos, plab, qtags, pvalid,
        num_valid, float(kappa_ann), float(kappa_occ))
    own_a, same_a, diff_a, own_o, same_o, diff_o = stats.unbind(0)
    ann = _ll_from_stats(own_a, same_a, diff_a, ann_pixel_mask, reduction)
    occ = _ll_from_stats(own_o, same_o, diff_o, occ_pixel_mask, reduction)
    return ann, occ
