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

Operand type (``operand_dtype``, the config's tpu.loss_operand_dtype, as
the JAX package's): "float32", or "bfloat16", where the embeddings and
prototypes are rounded to bf16 inside the autograd.Function (the JAX
custom VJP's cast), the kernels read them as bf16 (the ``_bf16`` C
functions, counted under their own LAUNCHES keys) and round the
gradients' coefficient c to bf16 before the second product; every sum
and every cotangent stays float32. The plain version of that form is an
autograd.Function too (``_PlainBf16``), with the same two roundings.
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
# tpu.loss_operand_dtype -> (type the kernels read E and P in, suffix of
# the C functions and of their LAUNCHES keys)
OPERAND_DTYPES = {"float32": (torch.float32, ""),
                  "bfloat16": (torch.bfloat16, "_bf16")}

# launches of each kernel, counted where the wrapper launches it: the C
# functions start no grid for a stats or dE call without pixels (N = 0,
# a height-sharded rank with no row of the embeddings) or a dP call
# without prototypes, and such a call counts none
LAUNCHES = {f"{family}_{kind}{suffix}": 0
            for _, suffix in OPERAND_DTYPES.values() for family in _FAMILIES
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


def _hard_terms(emb, pix_lab, own_idx, protos, proto_lab, num_valid,
                kappa):
    """[(mask [N, P], s [N, P], kappa)] of the hard-label statistics (own,
    same, diff), with the kernels' masks."""
    own, same, diff, _ = _label_masks(pix_lab, own_idx, proto_lab,
                                      num_valid)
    s = torch.exp((emb @ protos.T) * kappa)
    return [(own, s, kappa), (same, s, kappa), (diff, s, kappa)]


def _set_terms(emb, pix_tags, own_idx, protos, proto_tags, proto_valid,
               num_valid, kappa):
    """[(mask, s, kappa)] of the tag-set statistics (own, same, diff):
    own not gated by validity, same = the tag bitwords intersect, diff =
    they do not, both on valid prototypes."""
    own, live = _own_mask(own_idx, protos.shape[0], num_valid)
    same, diff = _tag_masks(pix_tags, proto_tags, proto_valid, live)
    s = torch.exp((emb @ protos.T) * kappa)
    return [(own, s, kappa), (same, s, kappa), (diff, s, kappa)]


def _joint_terms(emb, pix_lab, own_idx, pix_tags, protos, proto_lab,
                 proto_tags, proto_valid, num_valid, kappa_a, kappa_o):
    """[(mask, s, kappa)] of the six joint statistics (own_a, same_a,
    diff_a at kappa_a, own_o, same_o, diff_o at kappa_o)."""
    own, same_a, diff_a, live = _label_masks(pix_lab, own_idx,
                                             proto_lab, num_valid)
    logits = emb @ protos.T
    s_a = torch.exp(logits * kappa_a)
    s_o = s_a * s_a if kappa_o == 2.0 * kappa_a else torch.exp(
        logits * kappa_o)
    same_o, diff_o = _tag_masks(pix_tags, proto_tags, proto_valid, live)
    return [(own, s_a, kappa_a), (same_a, s_a, kappa_a),
            (diff_a, s_a, kappa_a), (own, s_o, kappa_o),
            (same_o, s_o, kappa_o), (diff_o, s_o, kappa_o)]


# family -> its terms
_TERMS = {"joint": _joint_terms, "hard": _hard_terms, "set": _set_terms}


def _stats_of(terms):
    """[NS, N]: the row sums of each statistic's s under its mask."""
    return torch.stack([_rowsum(mask, s) for mask, s, _ in terms])


def _coefficient_terms(terms, grads):
    """[kappa s g] of each concentration ([N, P] each, one for the hard
    and set families, two for the joint one), g the row cotangents grads
    [NS, N] picked by the statistics' masks and added in their order;
    their sum is the gradients' coefficient c, dE = c P and dP = c^T E
    (the TPU kernels' order: kappa_a s_a g_a + kappa_o s_o g_o)."""
    out = []
    for i in range(0, len(terms), 3):
        g = None
        for j, (mask, _, _) in enumerate(terms[i:i + 3]):
            picked = torch.where(mask, grads[i + j][:, None], 0.0)
            g = picked if g is None else g + picked
        _, s, kappa = terms[i]
        out.append(kappa * s * g)
    return out


def round_bf16(x):
    """x rounded to the nearest bf16 (ties to even), in x's type."""
    return x.to(torch.bfloat16).to(x.dtype)


def _operand(operand_dtype):
    """(torch dtype, C suffix) of a tpu.loss_operand_dtype name."""
    if operand_dtype not in OPERAND_DTYPES:
        raise ValueError(f"operand_dtype {operand_dtype!r}: not one of "
                         f"{sorted(OPERAND_DTYPES)}")
    return OPERAND_DTYPES[operand_dtype]


# How far a bf16 form's float32 c may lie from the exact c of the same
# bf16 values, as a share of its terms' magnitude: the dE / dP kernels'
# logits (one mma.sync accumulator over D) are off by up to ~1e-6 near
# |l| = 1, ~1.2e-5 of s after exp(12 l), plus a few float32 units of exp
# and the products; 2^-14 (6.1e-5) leaves a factor ~5.
C_REL_ERR = 2.0 ** -14


def bf16_rounding_spread(family, args, grads, rel=C_REL_ERR):
    """(dE [N, D], dP [P, D]): how far the bf16 forms' gradients may lie
    from _PlainBf16's through c's rounding alone. A pair whose c lies
    within r = rel * (the magnitude of its terms) of a bf16 rounding
    boundary may round to either side: it adds |bf16(c + r) - bf16(c -
    r)| |P[k]| to dE[n] (|E[n]| to dP[k]); every other pair adds 0.
    args: the family's stats arguments as _PlainBf16 takes them, in the
    working type; grads [NS, N]."""
    args = list(args)
    at = _FAMILIES[family][1]
    args[0], args[at] = round_bf16(args[0]), round_bf16(args[at])
    terms = _coefficient_terms(_TERMS[family](*args),
                               grads.to(args[0].dtype))
    c, mag = terms[0], terms[0].abs()
    for t in terms[1:]:
        c, mag = c + t, mag + t.abs()
    spread = (round_bf16(c + rel * mag) - round_bf16(c - rel * mag)).abs()
    return spread @ args[at].abs(), spread.T @ args[0].abs()


class _PlainBf16(torch.autograd.Function):
    """The plain version of the bf16-operand form, in the inputs' type:
    the statistics of E and P rounded to bf16, and a backward that rounds
    c to bf16 before c P and c^T E (the TPU kernels' .astype of c), as
    autograd through a cast would not. `args` are the family's stats
    arguments (E first, P at `at`, the concentrations last)."""

    @staticmethod
    def forward(ctx, family, at, *args):
        args = list(args)
        args[0], args[at] = round_bf16(args[0]), round_bf16(args[at])
        tensors = [a for a in args if torch.is_tensor(a)]
        ctx.save_for_backward(*tensors)
        ctx.family, ctx.at = family, at
        ctx.scalars = [None if torch.is_tensor(a) else a for a in args]
        return _stats_of(_TERMS[family](*args))

    @staticmethod
    def backward(ctx, grads):
        tensors = iter(ctx.saved_tensors)
        args = [next(tensors) if a is None else a for a in ctx.scalars]
        emb, protos = args[0], args[ctx.at]
        terms = _TERMS[ctx.family](*args)
        c = None
        for term in _coefficient_terms(terms, grads.to(emb.dtype)):
            c = term if c is None else c + term
        c = round_bf16(c)
        out = [None] * (2 + len(args))
        if ctx.needs_input_grad[2]:
            out[2] = c @ protos
        if ctx.needs_input_grad[2 + ctx.at]:
            out[2 + ctx.at] = c.T @ emb
        return tuple(out)


def _plain(family, at, args, operand_dtype):
    _operand(operand_dtype)
    if operand_dtype == "bfloat16":
        return _PlainBf16.apply(family, at, *args)
    return _stats_of(_TERMS[family](*args))


def segsort_stats_reference(emb, pix_lab, own_idx, protos, proto_lab,
                            num_valid, kappa, operand_dtype="float32"):
    """Dense [N, P] form of the hard-label statistics, with the kernels'
    masks; prototype rows at or past num_valid contribute nothing.
    Returns a [3, N] tensor (own, same, diff). operand_dtype "bfloat16":
    _PlainBf16."""
    return _plain("hard", 3, (emb, pix_lab, own_idx, protos, proto_lab,
                              num_valid, kappa), operand_dtype)


def set_segsort_stats_reference(emb, pix_tags, own_idx, protos, proto_tags,
                                proto_valid, num_valid, kappa,
                                operand_dtype="float32"):
    """Dense [N, P] form of the tag-set statistics, with the kernels'
    masks: own (not gated by validity), same = the tag bitwords
    intersect, diff = they do not, both on valid prototypes; rows at or
    past num_valid contribute nothing. Returns a [3, N] tensor (own,
    same, diff). operand_dtype "bfloat16": _PlainBf16."""
    return _plain("set", 3, (emb, pix_tags, own_idx, protos, proto_tags,
                             proto_valid, num_valid, kappa), operand_dtype)


def joint_segsort_stats_reference(emb, pix_lab, own_idx, pix_tags, protos,
                                  proto_lab, proto_tags, proto_valid,
                                  num_valid, kappa_a, kappa_o,
                                  operand_dtype="float32"):
    """Dense [N, P] form of the six statistics, with the kernels' masks;
    prototype rows at or past num_valid contribute nothing. Returns a
    [6, N] tensor (own_a, same_a, diff_a, own_o, same_o, diff_o).
    operand_dtype "bfloat16": _PlainBf16."""
    return _plain("joint", 4, (emb, pix_lab, own_idx, pix_tags, protos,
                               proto_lab, proto_tags, proto_valid,
                               num_valid, kappa_a, kappa_o), operand_dtype)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _c_args(family, inputs):
    """(pointers of the inputs, n, p, d) as the C functions take them."""
    emb, protos = inputs[0], inputs[_FAMILIES[family][1]]
    ptrs = [t.data_ptr() for t in inputs]
    return ptrs + [emb.shape[0], protos.shape[0], emb.shape[1]]


def _launch(family, kind, suffix, inputs, scalars, *tail):
    """Calls segsort_{family}_{kind}{suffix} on PyTorch's current stream
    (suffix "_bf16": the bf16-operand form); raises on a launch error and
    counts the launch, where the C function starts a grid (LAUNCHES)."""
    name = f"segsort_{family}_{kind}{suffix}"
    fn = getattr(_cuda.load(KERNEL_SOURCE), name)
    args = _c_args(family, inputs)
    err = fn(*args, *scalars, *tail, _cuda.stream_handle(inputs[0].device))
    _cuda.check(err, name)
    n, p = args[-3], args[-2]
    if (p if kind == "grad_proto" else n) > 0:
        LAUNCHES[f"{family}_{kind}{suffix}"] += 1


def _launch_stats(family, inputs, scalars, suffix=""):
    emb = inputs[0]
    out = torch.empty((_FAMILIES[family][0], emb.shape[0]),
                      dtype=torch.float32, device=emb.device)
    _launch(family, "stats", suffix, inputs, scalars, out.data_ptr())
    return out


def _launch_grad_emb(family, inputs, scalars, grads, suffix=""):
    # float32 whatever the operands' type
    d_emb = torch.empty(inputs[0].shape, dtype=torch.float32,
                        device=inputs[0].device)
    _launch(family, "grad_emb", suffix, inputs, scalars, grads.data_ptr(),
            d_emb.data_ptr())
    return d_emb


def _launch_grad_proto(family, inputs, scalars, grads, suffix=""):
    protos = inputs[_FAMILIES[family][1]]
    d_protos = torch.empty(protos.shape, dtype=torch.float32,
                           device=protos.device)
    blocks = dp_blocks(protos.shape[0])
    partial = torch.empty((blocks, OWN_ROWS, protos.shape[1]),
                          dtype=torch.float32, device=protos.device)
    _launch(family, "grad_proto", suffix, inputs, scalars, grads.data_ptr(),
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
    are in the C functions' argument order, the embeddings (first) and
    prototypes float32; gradients flow to those two only, in float32.
    operand_dtype "bfloat16" casts them to bf16 here, inside the
    Function (the JAX custom VJP's cast), and launches the _bf16 forms:
    the cotangents that leave are exact float32."""

    @staticmethod
    def forward(ctx, family, scalars, operand_dtype, *inputs):
        dtype, suffix = _operand(operand_dtype)
        at = _FAMILIES[family][1]
        inputs = list(inputs)
        for i in (0, at):
            inputs[i] = _kernel_operand(inputs[i], dtype)
        ctx.save_for_backward(*inputs)
        ctx.family, ctx.scalars, ctx.suffix = family, scalars, suffix
        return _launch_stats(family, inputs, scalars, suffix)

    @staticmethod
    def backward(ctx, grads):
        inputs = ctx.saved_tensors
        family, scalars, suffix = ctx.family, ctx.scalars, ctx.suffix
        at = _FAMILIES[family][1]
        grads = _kernel_operand(grads, torch.float32)
        out = [None] * (3 + len(inputs))
        if ctx.needs_input_grad[3]:
            out[3] = _launch_grad_emb(family, inputs, scalars, grads,
                                      suffix)
        if ctx.needs_input_grad[3 + at]:
            out[3 + at] = _launch_grad_proto(family, inputs, scalars, grads,
                                             suffix)
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
                  kappa, operand_dtype="float32"):
    """(own, same, diff) of the hard-label loss as a [3, N] float32
    tensor.

    emb [N, D], protos [P, D]; pix_lab / own_idx [N] and proto_lab [P]
    integers, a negative prototype label excluding the prototype from
    the same / diff sums; num_valid [1]: rows at or past it contribute
    nothing. operand_dtype: "float32" or "bfloat16" (module docstring).
    """
    if not emb.is_cuda:
        return segsort_stats_reference(emb.float(), pix_lab, own_idx,
                                       protos.float(), proto_lab, num_valid,
                                       kappa, operand_dtype)
    e, p, (lab, own, plab, nv) = _kernel_inputs(
        emb, protos, (pix_lab, own_idx, proto_lab, num_valid))
    return _SegsortStats.apply("hard", (float(kappa),), operand_dtype, e,
                               lab, own, p, plab, nv)


def set_segsort_stats(emb, pix_tags, own_idx, protos, proto_tags,
                      proto_valid, num_valid, kappa,
                      operand_dtype="float32"):
    """(own, same, diff) of the tag-set loss as a [3, N] float32 tensor.

    emb [N, D], protos [P, D]; pix_tags / own_idx [N] and proto_tags /
    proto_valid [P] integers, tags as bitwords; num_valid [1]: rows at or
    past it contribute nothing. operand_dtype: "float32" or "bfloat16".
    """
    if not emb.is_cuda:
        return set_segsort_stats_reference(
            emb.float(), pix_tags, own_idx, protos.float(), proto_tags,
            proto_valid, num_valid, kappa, operand_dtype)
    e, p, (tag, own, ptag, pval, nv) = _kernel_inputs(
        emb, protos, (pix_tags, own_idx, proto_tags, proto_valid,
                      num_valid))
    return _SegsortStats.apply("set", (float(kappa),), operand_dtype, e,
                               tag, own, p, ptag, pval, nv)


def joint_segsort_stats(emb, pix_lab, own_idx, pix_tags, protos, proto_lab,
                        proto_tags, proto_valid, num_valid, kappa_a,
                        kappa_o, operand_dtype="float32"):
    """Six statistics in one sweep: (own_a, same_a, diff_a) for the
    hard-label loss at kappa_a and (own_o, same_o, diff_o) for the tag
    loss at kappa_o, as a [6, N] float32 tensor.

    emb [N, D], protos [P, D]; pix_lab / own_idx / pix_tags [N] and
    proto_lab / proto_tags / proto_valid [P] integers, tags as bitwords;
    num_valid [1]: rows at or past it contribute nothing. operand_dtype:
    "float32" or "bfloat16".
    """
    if not emb.is_cuda:
        return joint_segsort_stats_reference(
            emb.float(), pix_lab, own_idx, pix_tags, protos.float(),
            proto_lab, proto_tags, proto_valid, num_valid, kappa_a, kappa_o,
            operand_dtype)
    e, p, (lab, own, tag, plab, ptag, pval, nv) = _kernel_inputs(
        emb, protos, (pix_lab, own_idx, pix_tags, proto_lab, proto_tags,
                      proto_valid, num_valid))
    square = int(kappa_o == 2.0 * kappa_a)
    return _SegsortStats.apply(
        "joint", (float(kappa_a), float(kappa_o), square), operand_dtype, e,
        lab, own, tag, p, plab, ptag, pval, nv)


def _num_valid_all(p, device):
    return torch.full((1,), p, dtype=torch.int32, device=device)


def fused_segsort_loss(embeddings, semantic_labels, own_segment_ids,
                       prototypes, prototype_semantic_labels, concentration,
                       pixel_mask, prototype_mask, reduction="mean",
                       compact=True, operand_dtype="float32"):
    """The hard-label SegSort loss (losses.segsort_loss) in one fused
    sweep: the masked mean, or the per-pixel [N] log likelihood with
    reduction="none". Prototypes outside prototype_mask take label -1
    and drop out of the same / diff sums. operand_dtype: the kernels'
    operand type, "float32" or "bfloat16" (module docstring)."""
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
        num_valid, float(concentration),
        operand_dtype=operand_dtype).unbind(0)
    return _ll_from_stats(own_s, same_s, diff_s, pixel_mask, reduction)


def fused_set_segsort_loss(embeddings, semantic_tags, own_segment_ids,
                           prototypes, prototype_semantic_tags,
                           concentration, pixel_mask, prototype_mask,
                           reduction="mean", compact=True,
                           operand_dtype="float32"):
    """The tag-set SegSort loss (losses.set_segsort_loss) in one fused
    sweep: the masked mean, or the per-pixel [N] log likelihood with
    reduction="none". Tag sets [N, T] / [P, T] (T <= 32; 0/1 or counts,
    nonzero meaning present) are packed to bitwords inside; prototypes
    outside prototype_mask drop out of the same / diff sums.
    operand_dtype: "float32" or "bfloat16"."""
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
        qtags, pvalid, num_valid, float(concentration),
        operand_dtype=operand_dtype).unbind(0)
    return _ll_from_stats(own_s, same_s, diff_s, pixel_mask, reduction)


def fused_joint_losses(embeddings, semantic_labels, own_segment_ids,
                       semantic_tags, prototypes, prototype_labels,
                       prototype_tags, kappa_ann, kappa_occ, ann_pixel_mask,
                       occ_pixel_mask, prototype_mask, reduction="mean",
                       compact=True, operand_dtype="float32"):
    """(sem_ann, sem_occ) masked-mean losses in one fused sweep, or the
    per-pixel [N] log-likelihood pair with reduction="none".

    prototype_labels must already be -1 for prototypes excluded from the
    hard-label loss; prototype_mask gates the tag loss. Tag sets [N, T] /
    [P, T] (T <= 32) are packed to bitwords inside. operand_dtype:
    "float32" or "bfloat16".
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
        num_valid, float(kappa_ann), float(kappa_occ),
        operand_dtype=operand_dtype)
    own_a, same_a, diff_a, own_o, same_o, diff_o = stats.unbind(0)
    ann = _ll_from_stats(own_a, same_a, diff_a, ann_pixel_mask, reduction)
    occ = _ll_from_stats(own_o, same_o, diff_o, occ_pixel_mask, reduction)
    return ann, occ
