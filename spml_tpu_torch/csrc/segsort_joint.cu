// SegSort statistics and their gradients: the fused loss sweeps of the SPML
// train step, for NVIDIA Hopper (sm_90a). One source serves three loss
// families, a compile-time parameter of every kernel:
//
//   JOINT: sem_ann (hard labels) + sem_occ (tag sets) in one sweep, six
//          row sums at two concentrations. Replaces, in
//          spml_tpu/ops/pallas/segsort_loss.py:
//     K1 segsort_joint_stats      <- _joint_stats_kernel (:664)
//     K2 segsort_joint_grad_emb   <- _joint_grad_kernel(transpose=False) (:716)
//     K3 segsort_joint_grad_proto <- _joint_grad_kernel(transpose=True) (:716)
//   HARD:  sem_ann alone (the DensePose point recipe, sem_occ off), three
//          row sums at one concentration. Replaces:
//     K4 segsort_hard_stats       <- _stats_kernel (:130)
//     K5 segsort_hard_grad_emb    <- _grad_coeff_kernel (:200)
//     K6 segsort_hard_grad_proto  <- _grad_proto_kernel (:240)
//   SET:   sem_occ alone (the VOC image-tag step with sem_ann off), three
//          row sums at one concentration under tag-set masks. Replaces:
//     K7 segsort_set_stats        <- _set_stats_kernel (:408)
//     K8 segsort_set_grad_emb     <- _set_grad_kernel(transpose=False) (:444)
//     K9 segsort_set_grad_proto   <- _set_grad_kernel(transpose=True) (:444)
//
// For N pixels and the first num_valid of P prototypes (sorted valid-first
// by the wrapper; rows past num_valid contribute exactly zero), with
// l = E[n].P[k], s_a = exp(kappa_a l), s_o = exp(kappa_o l) (s_a^2 when
// kappa_o == 2 kappa_a, as the TPU kernel does):
//   stats: row sums over k of s_a (and, JOINT, s_o) under the own
//       (k == own[n], not gated by the label or validity), same-label and
//       different-label masks (prototype label >= 0; JOINT and HARD), and
//       the tag-intersect and tag-disjoint masks (prototype valid; JOINT
//       at kappa_o, SET at kappa_a in place of the label masks);
//   dE[n] = sum_k c[n,k] P[k],   c = kappa_a s_a g_a (+ kappa_o s_o g_o),
//       g_a / g_o the incoming row cotangents picked by the same masks;
//   dP[k] = sum_n c[n,k] E[n].
//
// What bounds them on this card: operations, not bytes. Each (pixel,
// prototype) pair costs a D-long dot product (2D flops), one or two exps
// and the masked sums; the inputs are O((N + P) D) and read once. At the
// flagship shapes (N = 131072, P = 6144, D = 64) one JOINT sweep over a
// full prototype set is ~1e11 flops against ~40 MB of inputs. At the
// DensePose point shapes (N = 65536, P = 2048, D = 32, ~10-25% of the
// prototype rows live) a HARD sweep is ~1e9 flops, a bound of ~0.02 ms
// (a SET sweep of the tag step, N = 65536, P = 3072, D = 64, is alike):
// there the kernels are launch- and latency-bound, and the design keeps
// them to one launch each (two for dP) with no host round trip. The
// logits feed exp(kappa l), which amplifies TF32 or bf16 operand
// rounding, so the products run in split TF32 on the tensor cores (three
// TF32 products at 495 TFLOP/s, float32 sums).
//
// Design. The [N, P] similarity matrix never reaches device memory. All
//   nine kernels are tiled: the stats of the three families (K1, K4, K7)
//   on stats_tile_kernel, the dE (K2, K5, K8) and dP (K3, K6, K9) on
//   grad_tile_kernel. With float32 FMAs a D-long product takes 2D FFMA a
//   pair, and register tiles of 4 x 4 and 8 x 8 alike ran at ~48% of the
//   FFMA rate on an H100: the FP32 pipe issues the products and the ~40
//   exp, mask and select instructions of the middle. So the products go
//   to the tensor cores, in split TF32: x = hi + lo (each TF32), a b = hi
//   hi + hi lo + lo hi (three mma.sync m16n8k8, float32 sums), about
//   2^-21 of each product off, where plain TF32 (2^-11) would be
//   amplified by exp(kappa l). The middle stays in float32. The splits are
//   integer operations (cvt.rna.tf32 runs at a quarter of the rate), and
//   the streamed tile is split once for all warps. A block of 128 threads
//   owns OWN = 128 rows of one side (pixels for stats and dE, valid
//   prototypes for dP) and walks tiles of STR = 64 rows of the other,
//   staged by cp.async into a double buffer (zero-filled past the count).
//   Per tile a warp takes its 32 own rows: S = own . other^T (product 1).
//     stats: the masked similarities are added to per-tile partial sums
//     in registers, then to running sums (two-level summation keeps the
//     6144-term sums accurate to ~1e-6); at the end the four lanes of a
//     row add their sums in a fixed order. Its product 1 (stats_logits)
//     sums each k step in a fresh accumulator: mma.sync's float32 sums
//     truncate against the accumulator, and one accumulator over all D
//     cost the one-term own statistic at kappa 12 its whole rtol of 1e-5.
//     Its middle is branch-free (predicated adds) and takes s =
//     2^(kappa log2(e) l) on the SFU.
//     dE, dP: c = kappa_a s_a g_a + kappa_o s_o g_o under the masks, in
//     place, in registers; then acc += c . other (product 2), in registers
//     over one tile, added to the output after each tile (mma.sync's
//     truncating sums stay short); c never leaves the registers. A
//     warp whose own rows lie past the count skips the products. dE also
//     skips the pixels whose cotangents are all zero, where c is 0 on
//     every pair: a warp none of whose rows carries a nonzero cotangent
//     skips both products and writes +0 rows, and a block with no such
//     warp stages nothing and walks no tile (the DensePose step puts ~0.5%
//     of its pixels in the loss). mma.sync's rate bounds the products; the
//     float32 middle adds to that rather than hiding under it (two blocks,
//     eight warps, a SM). The dE and dP of a family take each logit through
//     tile_logits and agree on it bit for bit (K2 and K3, K5 and K6, K8 and
//     K9); the stats' logits (stats_logits) are closer to float32's and
//     differ from theirs by up to ~1e-6 (K1's from K2's and K3's, K4's
//     from K5's and K6's, K7's from K8's and K9's).
//     Stats and dE are written once, in a fixed order. dP: the grid
//     (`blocks` >= ceil(P / OWN), 264 from the wrapper: 2 a SM) is split
//     on the device, from num_valid, into ceil(num_valid / OWN) prototype
//     tiles times blocks / tiles pixel chunks of equal length, so the live
//     tiles fill the card whatever the fill; each block writes an [OWN, D]
//     partial and reduce_tiles_kernel adds a tile's chunks in chunk order.
//     ops/segsort_loss.py mirrors this schedule (stats_tiles,
//     grad_emb_tiles, grad_proto_tiles) for the CPU tests.
//   No dP uses float atomics: the result does not depend on the run.
// Left for later: the dP kernel skipping pixel tiles whose cotangents are
// all zero; wgmma products for K2 and K3.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int JOINT = 0;
constexpr int HARD = 1;
constexpr int SET = 2;  // rows carry no label: tag bitwords and validity

__host__ __device__ constexpr int n_stats(int family) {
  return family == JOINT ? 6 : 3;
}

constexpr int REDUCE_THREADS = 256;

struct PairMasks {
  bool own, same_a, diff_a, same_o, diff_o;
};

__device__ __forceinline__ PairMasks pair_masks(int k, int own_k, int lab,
                                                int tag, int plab, int ptag,
                                                int pvalid) {
  PairMasks m;
  m.own = k == own_k;
  const bool lab_ok = plab >= 0;
  m.same_a = lab_ok && lab == plab;
  m.diff_a = lab_ok && lab != plab;
  const bool tag_ok = pvalid > 0;
  const bool inter = (tag & ptag) != 0;
  m.same_o = tag_ok && inter;
  m.diff_o = tag_ok && !inter;
  return m;
}

template <int F>
__device__ __forceinline__ void sims(float l, float kappa_a, float kappa_o,
                                     int square, float& sa, float& so) {
  sa = expf(l * kappa_a);
  if constexpr (F == JOINT) {
    so = square ? sa * sa : expf(l * kappa_o);
  } else {
    so = 0.f;
  }
}

// Adds one pair's similarities to the family's row sums: JOINT (own_a,
// same_a, diff_a, own_o, same_o, diff_o), HARD (own, same, diff by label),
// SET (own, same, diff by tag set). Predicated adds (one instruction where
// a select and an add take two): the sums start at +0 and take positive
// terms, so skipping a pair outside a mask gives the bits of adding +0.
// JOINT's caller rounds s_o = s_a^2 itself (__fmul_rn), so it is not
// fused into the add and the sums keep the bits of the selects.
template <int F>
__device__ __forceinline__ void add_pair(float (&acc)[n_stats(F)],
                                         const PairMasks& m, float sa,
                                         float so) {
  if (m.own) acc[0] += sa;
  if constexpr (F == SET) {
    if (m.same_o) acc[1] += sa;
    if (m.diff_o) acc[2] += sa;
  } else {
    if (m.same_a) acc[1] += sa;
    if (m.diff_a) acc[2] += sa;
  }
  if constexpr (F == JOINT) {
    if (m.own) acc[3] += so;
    if (m.same_o) acc[4] += so;
    if (m.diff_o) acc[5] += so;
  }
}

// c[n, k] of one pair from the row cotangents g (laid out as the stats).
template <int F>
__device__ __forceinline__ float pair_coeff(const PairMasks& m,
                                            const float (&g)[n_stats(F)],
                                            float sa, float so,
                                            float kappa_a, float kappa_o) {
  if constexpr (F == SET) {
    const float gs = (m.own ? g[0] : 0.f) + (m.same_o ? g[1] : 0.f) +
                     (m.diff_o ? g[2] : 0.f);
    return kappa_a * sa * gs;
  } else {
    const float ga = (m.own ? g[0] : 0.f) + (m.same_a ? g[1] : 0.f) +
                     (m.diff_a ? g[2] : 0.f);
    if constexpr (F == JOINT) {
      const float go = (m.own ? g[3] : 0.f) + (m.same_o ? g[4] : 0.f) +
                       (m.diff_o ? g[5] : 0.f);
      return kappa_a * sa * ga + kappa_o * so * go;
    } else {
      return kappa_a * sa * ga;
    }
  }
}

// ---------------------------------------------------------------------------
// Tiled kernels: stats (K1, K4, K7), dE (K2, K5, K8), dP (K3, K6, K9)
// ---------------------------------------------------------------------------

constexpr int OWN = 128;           // own rows of a block
constexpr int STR = 64;            // streamed rows of a tile
constexpr int TILE_THREADS = 128;  // 4 warps, 32 own rows each

template <int NS, int ROWS>
struct PixelRows {  // per-pixel operands (zero past the count)
  int lab[ROWS], own[ROWS], tag[ROWS];
  float g[NS][ROWS];
};

template <int ROWS>
struct ProtoRows {
  int lab[ROWS], tag[ROWS], valid[ROWS];
};

// Both sides row-major, padded by 4 floats: the 8 rows x 4 columns of an
// mma fragment, and the 4 row pairs x 8 columns of product 2's B, fall
// in 32 distinct banks. other_hi / other_lo: the streamed tile's TF32
// halves, split once a tile for all four warps.
// Pixels own, prototype tiles streamed (stats, dE): a thread keeps its own
// pixels' operands in registers, read from device memory up front.
template <int D>
struct PixelTileSmem {
  float own[OWN][D + 4];
  float other[2][STR][D + 4];
  unsigned other_hi[STR][D + 4], other_lo[STR][D + 4];
  ProtoRows<STR> proto[2];
};

// Prototypes own, pixel tiles streamed (dP).
template <int D, int F>
struct ProtoTileSmem {
  float own[OWN][D + 4];
  float other[2][STR][D + 4];
  unsigned other_hi[STR][D + 4], other_lo[STR][D + 4];
  PixelRows<n_stats(F), STR> pix[2];
  ProtoRows<OWN> proto;
};

template <int D, int F, bool DP>
using TileSmem =
    std::conditional_t<DP, ProtoTileSmem<D, F>, PixelTileSmem<D>>;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS)' operands of the masks and c by cp.async, zero past
// the count (HARD reads no tag bits or validity, SET no label).
template <int F, int ROWS>
__device__ __forceinline__ void stage_pixel_rows(
    PixelRows<n_stats(F), ROWS>& s, const int* pix_lab, const int* own,
    const int* pix_tag, const float* grads, int n, int r0) {
  for (int r = threadIdx.x; r < ROWS; r += TILE_THREADS) {
    const bool live = r0 + r < n;
    const int row = live ? r0 + r : 0;
    if constexpr (F == SET) {
      s.lab[r] = -1;
    } else {
      cp_async4(&s.lab[r], pix_lab + row, live);
    }
    cp_async4(&s.own[r], own + row, live);
    if constexpr (F == HARD) {
      s.tag[r] = 0;
    } else {
      cp_async4(&s.tag[r], pix_tag + row, live);
    }
#pragma unroll
    for (int k = 0; k < n_stats(F); ++k)
      cp_async4(&s.g[k][r], grads + (size_t)k * n + row, live);
  }
}

template <int F, int ROWS>
__device__ __forceinline__ void stage_proto_rows(
    ProtoRows<ROWS>& s, const int* proto_lab, const int* proto_tag,
    const int* proto_valid, int nv, int r0) {
  for (int r = threadIdx.x; r < ROWS; r += TILE_THREADS) {
    const bool live = r0 + r < nv;
    const int row = live ? r0 + r : 0;
    if constexpr (F == SET) {
      s.lab[r] = -1;
    } else {
      cp_async4(&s.lab[r], proto_lab + row, live);
    }
    if constexpr (F == HARD) {
      s.tag[r] = 0;
      s.valid[r] = 0;
    } else {
      cp_async4(&s.tag[r], proto_tag + row, live);
      cp_async4(&s.valid[r], proto_valid + row, live);
    }
  }
}

// Rows [r0, r0 + ROWS) of src, zero-filled from `count` on, by cp.async.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(float (*dst)[D + 4],
                                           const float* src, int r0,
                                           int count) {
  for (int i = threadIdx.x; i < ROWS * D / 4; i += TILE_THREADS) {
    const int r = i / (D / 4), q = i % (D / 4);
    const bool live = r0 + r < count;
    cp_async16(&dst[r][4 * q], src + (size_t)(live ? r0 + r : 0) * D + 4 * q,
               live);
  }
}

// One row's operands of the masks and c, in registers.
template <int NS>
struct PixelOp {
  int lab, own, tag;
  bool live;
  float g[NS];
};

struct ProtoOp {
  int k, lab, tag, valid;
  bool live;
};

template <int NS, int ROWS>
__device__ __forceinline__ PixelOp<NS> pixel_op(
    const PixelRows<NS, ROWS>& s, int r, int r0, int n) {
  PixelOp<NS> x;
  x.lab = s.lab[r];
  x.own = s.own[r];
  x.tag = s.tag[r];
  x.live = r0 + r < n;
#pragma unroll
  for (int k = 0; k < NS; ++k) x.g[k] = s.g[k][r];
  return x;
}

// Row `row`'s operands from device memory, zero past the count.
template <int F>
__device__ __forceinline__ PixelOp<n_stats(F)> pixel_op_at(
    const int* pix_lab, const int* own, const int* pix_tag,
    const float* grads, int n, int row) {
  PixelOp<n_stats(F)> x;
  x.live = row < n;
  x.lab = -1;
  x.own = -1;
  x.tag = 0;
#pragma unroll
  for (int k = 0; k < n_stats(F); ++k) x.g[k] = 0.f;
  if (x.live) {
    if constexpr (F != SET) x.lab = pix_lab[row];
    x.own = own[row];
    if constexpr (F != HARD) x.tag = pix_tag[row];
#pragma unroll
    for (int k = 0; k < n_stats(F); ++k) x.g[k] = grads[(size_t)k * n + row];
  }
  return x;
}

template <int ROWS>
__device__ __forceinline__ ProtoOp proto_op(const ProtoRows<ROWS>& s, int r,
                                            int r0, int nv) {
  return ProtoOp{r0 + r, s.lab[r], s.tag[r], s.valid[r], r0 + r < nv};
}

// x = hi + lo: hi is x rounded to the nearest TF32 (10 explicit mantissa
// bits, ties away from zero) by integer operations on its bits; lo = x -
// hi is exact in float32, and the tensor core reads it as TF32 by
// truncation, 2^-21 of x at most. (cvt.rna.tf32.f32 takes the
// quarter-rate conversion pipe: on an H100 it made this kernel slower
// than the float32 FMA form.)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in float32 from split operands: lo lo (2^-22 of the product)
// is dropped, the two small products go first.
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const unsigned (&ahi)[4],
                                          const unsigned (&alo)[4],
                                          const unsigned (&bhi)[2],
                                          const unsigned (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// A staged tile's TF32 halves, once for the four warps.
template <int D>
__device__ __forceinline__ void split_tile(const float (*raw)[D + 4],
                                           unsigned (*hi)[D + 4],
                                           unsigned (*lo)[D + 4]) {
  for (int i = threadIdx.x; i < STR * D / 4; i += TILE_THREADS) {
    const int r = i / (D / 4), q = 4 * (i % (D / 4));
    const float4 v = *reinterpret_cast<const float4*>(&raw[r][q]);
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(&hi[r][q]) = h;
    *reinterpret_cast<uint4*>(&lo[r][q]) = l;
  }
}

// Product 1's A fragment at k step d0 / 8: own rows m0 + 16 mt (+ g, + 8),
// columns d0 + (t, t + 4), split from float32.
template <int D>
__device__ __forceinline__ void own_fragments(unsigned (&ahi)[2][4],
                                              unsigned (&alo)[2][4],
                                              const float (*own)[D + 4],
                                              int m0, int g, int t,
                                              int d0) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = m0 + 16 * mt + g;
    split_tf32(own[r][d0 + t], ahi[mt][0], alo[mt][0]);
    split_tf32(own[r + 8][d0 + t], ahi[mt][1], alo[mt][1]);
    split_tf32(own[r][d0 + t + 4], ahi[mt][2], alo[mt][2]);
    split_tf32(own[r + 8][d0 + t + 4], ahi[mt][3], alo[mt][3]);
  }
}

// Product 1's B fragment of n tile nt at k step d0 / 8: streamed row 8 nt
// + g, columns d0 + (t, t + 4), from the tile's halves.
template <int D>
__device__ __forceinline__ void streamed_fragment(unsigned (&bhi)[2],
                                                  unsigned (&blo)[2],
                                                  const unsigned (*hi)[D + 4],
                                                  const unsigned (*lo)[D + 4],
                                                  int nt, int g, int t,
                                                  int d0) {
  bhi[0] = hi[8 * nt + g][d0 + t];
  blo[0] = lo[8 * nt + g][d0 + t];
  bhi[1] = hi[8 * nt + g][d0 + t + 4];
  blo[1] = lo[8 * nt + g][d0 + t + 4];
}

// Product 1 of a tile, the logits: s[mt][nt][2 h + e] = own row m0 + 16 mt
// + g + 8 h . streamed row 8 nt + 2 t + e, in split TF32 (the own rows
// split here, the streamed tile from its halves), summed over all D in one
// accumulator (dE, dP).
template <int D>
__device__ __forceinline__ void tile_logits(float (&s)[2][STR / 8][4],
                                            const float (*own)[D + 4],
                                            const unsigned (*hi)[D + 4],
                                            const unsigned (*lo)[D + 4],
                                            int m0, int g, int t) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < STR / 8; ++nt)
      s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    unsigned ahi[2][4], alo[2][4];
    own_fragments<D>(ahi, alo, own, m0, g, t, 8 * ks);
#pragma unroll
    for (int nt = 0; nt < STR / 8; ++nt) {
      unsigned bhi[2], blo[2];
      streamed_fragment<D>(bhi, blo, hi, lo, nt, g, t, 8 * ks);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma_split(s[mt][nt], ahi[mt], alo[mt], bhi, blo);
    }
  }
}

// The logits of tile_logits for the statistics. mma.sync's float32 sums
// truncate against the accumulator's magnitude: a logit summed over all D
// in one accumulator is off by up to ~1e-6 near |l| = 1, which exp(12 l)
// makes ~1.3e-5 of a one-term statistic, past the stats check's rtol of
// 1e-5 (measured on an H100). So each k step (8 dimensions) goes into a fresh
// accumulator, and the steps are added in float32 (round to nearest); the
// steps run n tile by n tile, so only one accumulator stays live beside
// the logits.
template <int D>
__device__ __forceinline__ void stats_logits(float (&s)[2][STR / 8][4],
                                             const float (*own)[D + 4],
                                             const unsigned (*hi)[D + 4],
                                             const unsigned (*lo)[D + 4],
                                             int m0, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    unsigned ahi[2][4], alo[2][4];
    own_fragments<D>(ahi, alo, own, m0, g, t, 8 * ks);
#pragma unroll
    for (int nt = 0; nt < STR / 8; ++nt) {
      unsigned bhi[2], blo[2];
      streamed_fragment<D>(bhi, blo, hi, lo, nt, g, t, 8 * ks);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_split(part, ahi[mt], alo[mt], bhi, blo);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[mt][nt][i] = ks == 0 ? part[i] : s[mt][nt][i] + part[i];
      }
    }
  }
}

// DP = false (dE): the block owns pixels [OWN b, OWN b + OWN) and walks
// the valid prototypes in tiles of STR; out = dE [N, D]. A warp none of
// whose rows below N carries a nonzero cotangent (-0 counts as 0) skips
// both products: c = kappa s 0 = 0 on all its pairs (s is finite for unit
// rows), so its rows are the accumulator's +0. A block with no live warp
// stages nothing and walks no tile; it still writes its +0 rows.
// DP = true (dP): gridDim.x blocks split, from num_valid, into `tiles` =
// ceil(num_valid / OWN) prototype tiles times `chunks` = gridDim.x / tiles
// pixel chunks (pixel tiles [chunk NT / chunks, (chunk + 1) NT / chunks)
// of NT = ceil(N / STR)); block tile * chunks + chunk writes its partial
// out[block] = [OWN, D]; blocks past tiles * chunks exit.
// Warp w owns rows m0 = 32 w .. m0 + 31 in both products (m16n8k8 tiles
// m0 and m0 + 16); lane (g, t) = (lane / 4, lane % 4) holds the pairs of
// own rows m0 + 16 mt + g + 8 h and streamed rows 8 nt + 2 t + e, the
// accumulator layout of product 1, which is product 2's A operand once the
// streamed rows of a k step are taken in the order 2 t, 2 t + 1 (k = t,
// t + 4): c never leaves the registers.
template <int D, int F, bool DP>
__global__ void __launch_bounds__(TILE_THREADS, 2) grad_tile_kernel(
    const float* __restrict__ emb, const int* __restrict__ pix_lab,
    const int* __restrict__ own, const int* __restrict__ pix_tag,
    const float* __restrict__ protos, const int* __restrict__ proto_lab,
    const int* __restrict__ proto_tag, const int* __restrict__ proto_valid,
    const int* __restrict__ num_valid, int n, int p, float kappa_a,
    float kappa_o, int square, const float* __restrict__ grads,
    float* __restrict__ out) {
  constexpr int NS = n_stats(F);
  constexpr int NT = STR / 8;  // product 1's n tiles, product 2's k steps
  constexpr int KD = D / 8;    // product 2's n tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<TileSmem<D, F, DP>*>(smem_raw);
  const int nv = min(*num_valid, p);

  int own0, o_begin, o_end;  // own rows from own0; streamed [o_begin, o_end)
  if constexpr (DP) {
    if (nv == 0) return;  // uniform over the block
    const int tiles = (nv + OWN - 1) / OWN;
    const int chunks = gridDim.x / tiles;
    if ((int)blockIdx.x >= tiles * chunks) return;
    const int chunk = blockIdx.x % chunks;
    own0 = blockIdx.x / chunks * OWN;
    const long long nt = (n + STR - 1) / STR;
    o_begin = (int)(chunk * nt / chunks) * STR;
    o_end = min(n, (int)((chunk + 1) * nt / chunks) * STR);
  } else {
    own0 = blockIdx.x * OWN;
    o_begin = 0;
    o_end = nv;
  }
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4,
            t = threadIdx.x % 4;
  const int m0 = 32 * warp;
  // the thread's four own rows' operands: dE's from device memory here,
  // dP's from shared memory after the first tile's barrier
  PixelOp<NS> own_px[2][2];
  ProtoOp own_pr[2][2];
  bool warp_live;  // else the warp skips both products
  if constexpr (DP) {
    warp_live = own0 + m0 < nv;  // rows past the count take no part
  } else {
    bool carries = false;  // one of the thread's rows has a cotangent
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        own_px[mt][h] = pixel_op_at<F>(pix_lab, own, pix_tag, grads, n,
                                       own0 + m0 + 16 * mt + g + 8 * h);
#pragma unroll
        for (int k = 0; k < NS; ++k) carries |= own_px[mt][h].g[k] != 0.f;
      }
    warp_live = __any_sync(0xffffffffu, carries);
    if (!__syncthreads_or(warp_live)) o_end = o_begin;  // the whole block
  }
  float acc[2][KD][4];
  auto clear = [&] {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int dn = 0; dn < KD; ++dn)
        acc[mt][dn][0] = acc[mt][dn][1] = acc[mt][dn][2] = acc[mt][dn][3] =
            0.f;
  };
  // acc[mt][dn][2 h + e]: own row m0 + 16 mt + g + 8 h, column 8 dn + 2 t
  // + e; stored to the thread's output elements, or added to them (out +
  // acc, float32, round to nearest). The loads of an m tile's rows go
  // first, so a warp waits on two round trips (the registers of c are
  // free by then; all four rows' loads at once spilled at D = 64).
  auto row_out = [&](int mt, int h) -> float* {
    const int row = m0 + 16 * mt + g + 8 * h;
    if constexpr (DP) return out + ((size_t)blockIdx.x * OWN + row) * D;
    return own0 + row < n ? out + (size_t)(own0 + row) * D : nullptr;
  };
  auto write = [&](bool add) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float2 sum[2][KD];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* dst = row_out(mt, h);
#pragma unroll
        for (int dn = 0; dn < KD; ++dn)
          sum[h][dn] = add && dst ? *reinterpret_cast<const float2*>(
                                        dst + 8 * dn + 2 * t)
                                  : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dst = row_out(mt, h);
        if (!dst) continue;
#pragma unroll
        for (int dn = 0; dn < KD; ++dn)
          *reinterpret_cast<float2*>(dst + 8 * dn + 2 * t) = make_float2(
              add ? sum[h][dn].x + acc[mt][dn][2 * h] : acc[mt][dn][2 * h],
              add ? sum[h][dn].y + acc[mt][dn][2 * h + 1]
                  : acc[mt][dn][2 * h + 1]);
      }
    }
  };
  clear();

  auto stage = [&](int buf, int r0) {
    if constexpr (DP) {
      stage_rows<D, STR>(sm.other[buf], emb, r0, n);
      stage_pixel_rows<F>(sm.pix[buf], pix_lab, own, pix_tag, grads,
                                n, r0);
    } else {
      stage_rows<D, STR>(sm.other[buf], protos, r0, nv);
      stage_proto_rows<F>(sm.proto[buf], proto_lab, proto_tag,
                                proto_valid, nv, r0);
    }
    cp_async_commit();
  };
  if (o_begin < o_end) {
    stage_rows<D, OWN>(sm.own, DP ? protos : emb, own0, DP ? nv : n);
    if constexpr (DP) {
      stage_proto_rows<F>(sm.proto, proto_lab, proto_tag, proto_valid, nv,
                          own0);
    }
    stage(0, o_begin);
  }

  int buf = 0;
  for (int t0 = o_begin; t0 < o_end; t0 += STR, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile landed; every thread left the last one
    split_tile<D>(sm.other[buf], sm.other_hi, sm.other_lo);
    __syncthreads();
    if (t0 + STR < o_end) stage(buf ^ 1, t0 + STR);
    if (!warp_live) continue;
    if constexpr (DP) {
      if (t0 == o_begin) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            own_pr[mt][h] =
                proto_op(sm.proto, m0 + 16 * mt + g + 8 * h, own0, nv);
      }
    }

    float s[2][NT][4];
    tile_logits<D>(s, sm.own, sm.other_hi, sm.other_lo, m0, g, t);

    // c in place of the logits: s[mt][nt][2 h + e] is the pair (own row
    // m0 + 16 mt + g + 8 h, streamed row 8 nt + 2 t + e)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * nt + 2 * t + e;
        PixelOp<NS> px;
        ProtoOp pr;
        if constexpr (DP) {
          px = pixel_op(sm.pix[buf], r, t0, n);
        } else {
          pr = proto_op(sm.proto[buf], r, t0, nv);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const PixelOp<NS>& x = DP ? px : own_px[mt][h];
            const ProtoOp& y = DP ? own_pr[mt][h] : pr;
            float& sv = s[mt][nt][2 * h + e];
            float sa, so;
            sims<F>(sv, kappa_a, kappa_o, square, sa, so);
            const PairMasks m =
                pair_masks(y.k, x.own, x.lab, x.tag, y.lab, y.tag, y.valid);
            sv = x.live && y.live
                     ? pair_coeff<F>(m, x.g, sa, so, kappa_a, kappa_o)
                     : 0.f;
          }
      }
    }

    // product 2: acc[mt][dn] += c (own rows x streamed rows) . streamed
    // rows' columns 8 dn .. 8 dn + 7, k step ks = streamed rows 8 ks +
    // (2 t, 2 t + 1) as k = (t, t + 4). acc holds one tile (8 k steps)
    // and is then added to the output in float32 (round to nearest):
    // mma.sync's sums truncate against the accumulator, and one
    // accumulator over every streamed row (hundreds of k steps) cost a dE
    // whose terms cancel (the log-likelihood cotangents of the VOC
    // scribble driver's stage 1) up to ~1e-5 of its terms' magnitude, 3x
    // the plain float32 version's error (measured on an H100); per tile,
    // 0.25x. A fresh accumulator per k step, as stats_logits has, made
    // ptxas spill every D = 32 and 64 form; the flush costs 4-14% a
    // launch.
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      unsigned ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        split_tf32(s[mt][ks][0], ahi[mt][0], alo[mt][0]);
        split_tf32(s[mt][ks][2], ahi[mt][1], alo[mt][1]);
        split_tf32(s[mt][ks][1], ahi[mt][2], alo[mt][2]);
        split_tf32(s[mt][ks][3], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        unsigned bhi[2], blo[2];
        bhi[0] = sm.other_hi[8 * ks + 2 * t][8 * dn + g];
        blo[0] = sm.other_lo[8 * ks + 2 * t][8 * dn + g];
        bhi[1] = sm.other_hi[8 * ks + 2 * t + 1][8 * dn + g];
        blo[1] = sm.other_lo[8 * ks + 2 * t + 1][8 * dn + g];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_split(acc[mt][dn], ahi[mt], alo[mt], bhi, blo);
      }
    }
    // the tile's sums, out of the accumulator: see product 2's note
    write(t0 != o_begin);
    clear();
  }
  if (!warp_live || o_begin == o_end) write(false);  // +0 rows
}

// 2^x by the SFU (ex2.approx, ~2 ulp); x = kappa l log2(e) lies far above
// the denormal range (|l| <= 1 for unit rows, kappa <= ~20).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Blocks a SM the stats kernel is built for. SET at D <= 32 takes 3 (168
// registers; 3 x 55.5 KB of shared memory at D = 32): allowed 255
// registers, ptxas spilled its D = 32 form. JOINT keeps 2 (at 168
// registers its D = 16 form spilled); at D = 64 two blocks fill the
// shared memory. HARD keeps 2: at D = 32 it builds to 255 registers with
// no spill, and ran K4 ~11% faster than at 3 blocks (168) on an H100.
__host__ __device__ constexpr int stats_min_blocks(int d, int family) {
  return d <= 32 && family == SET ? 3 : 2;
}

// The statistics, out [NS, N]: the block owns pixels [OWN b, OWN b + OWN)
// and walks the valid prototypes in tiles of STR, as the dE kernel does,
// with product 1 alone (stats_logits). Lane (g, t) of warp w adds its
// pairs (own rows m0 + 16 mt + g + 8 h, streamed rows 8 nt + 2 t + e, in
// the order nt, e) into a tile's partial sums, added to its running sums
// once a tile. At the end the quad t = 0..3 of a row adds its four sums as
// (t0 + t1) + (t2 + t3), every lane to the same bits, and lane t writes
// statistics t and t + 4: no atomics, the same result on every run.
// The middle has no branch: a streamed row past the count takes no own
// index, label or validity, so its pairs add nothing under the masks (the
// adds are predicated); s = 2^(l kappa log2(e)) with kappa log2(e) taken
// once; SQUARE (kappa_o = 2 kappa_a, JOINT) is a template argument, so
// s_o = s_a^2 costs one multiply a pair. (Skipping the last tile's 8-row
// n tiles wholly past the count, by a test uniform over the block, cost
// K1 and K7 ~17% on an H100: ptxas no longer interleaved the n tiles'
// products.)
template <int D, int F, bool SQUARE>
__global__ void __launch_bounds__(TILE_THREADS, stats_min_blocks(D, F))
    stats_tile_kernel(
    const float* __restrict__ emb, const int* __restrict__ pix_lab,
    const int* __restrict__ own, const int* __restrict__ pix_tag,
    const float* __restrict__ protos, const int* __restrict__ proto_lab,
    const int* __restrict__ proto_tag, const int* __restrict__ proto_valid,
    const int* __restrict__ num_valid, int n, int p, float kappa_a,
    float kappa_o, float* __restrict__ out) {
  constexpr int NS = n_stats(F);
  constexpr float LOG2E = 1.4426950408889634f;
  const float ka2 = kappa_a * LOG2E, ko2 = kappa_o * LOG2E;
  constexpr int NT = STR / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<PixelTileSmem<D>*>(smem_raw);
  const int nv = min(*num_valid, p);
  const int own0 = blockIdx.x * OWN;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4,
            t = threadIdx.x % 4;
  const int m0 = 32 * warp;
  const bool warp_live = own0 + m0 < n;  // else it skips the tiles' work

  // the thread's four own rows' operands
  int lab[2][2], own_k[2][2], tag[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = own0 + m0 + 16 * mt + g + 8 * h;
      const bool live = row < n;
      lab[mt][h] = -1;
      tag[mt][h] = 0;
      if constexpr (F != SET) {
        if (live) lab[mt][h] = pix_lab[row];
      }
      if constexpr (F != HARD) {
        if (live) tag[mt][h] = pix_tag[row];
      }
      own_k[mt][h] = live ? own[row] : -1;
    }
  float acc[2][2][NS];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < NS; ++k) acc[mt][h][k] = 0.f;

  auto stage = [&](int buf, int r0) {
    stage_rows<D, STR>(sm.other[buf], protos, r0, nv);
    stage_proto_rows<F>(sm.proto[buf], proto_lab, proto_tag, proto_valid,
                        nv, r0);
    cp_async_commit();
  };
  if (nv > 0) {
    stage_rows<D, OWN>(sm.own, emb, own0, n);
    stage(0, 0);
  }

  int buf = 0;
  for (int t0 = 0; t0 < nv; t0 += STR, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile landed; every thread left the last one
    split_tile<D>(sm.other[buf], sm.other_hi, sm.other_lo);
    __syncthreads();
    if (t0 + STR < nv) stage(buf ^ 1, t0 + STR);
    if (!warp_live) continue;

    float s[2][NT][4];
    stats_logits<D>(s, sm.own, sm.other_hi, sm.other_lo, m0, g, t);
    float part[2][2][NS];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < NS; ++k) part[mt][h][k] = 0.f;
    // s[mt][nt][2 h + e] is the pair (own row m0 + 16 mt + g + 8 h,
    // streamed row 8 nt + 2 t + e)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const ProtoOp y = proto_op(sm.proto[buf], 8 * nt + 2 * t + e, t0, nv);
        // past the count: no own index (-1 marks pixel rows past N, which
        // are not written), no label, not valid
        const int k = y.live ? y.k : -2;
        const int plab = y.live ? y.lab : -1;
        const int pvalid = y.live ? y.valid : 0;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float l = s[mt][nt][2 * h + e];
            const float sa = ex2(l * ka2);
            float so = 0.f;
            if constexpr (F == JOINT)
              so = SQUARE ? __fmul_rn(sa, sa) : ex2(l * ko2);
            add_pair<F>(part[mt][h],
                        pair_masks(k, own_k[mt][h], lab[mt][h], tag[mt][h],
                                   plab, y.tag, pvalid),
                        sa, so);
          }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < NS; ++k) acc[mt][h][k] += part[mt][h][k];
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = own0 + m0 + 16 * mt + g + 8 * h;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        float v = acc[mt][h][k];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (k % 4 == t && row < n) out[(size_t)k * n + row] = v;
      }
    }
}

// d_protos[k][d] = the sum of k's rows in the partials of its tile's
// chunks, in chunk order, for k < num_valid (the split of
// grad_tile_kernel<DP = true> over `blocks`); 0 past it.
__global__ void reduce_tiles_kernel(const float* __restrict__ partial,
                                    const int* __restrict__ num_valid, int p,
                                    int d, int blocks,
                                    float* __restrict__ d_protos) {
  const size_t idx = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (idx >= (size_t)p * d) return;
  const int nv = min(*num_valid, p);
  const int k = (int)(idx / d);
  float s = 0.f;
  if (k < nv) {
    const int chunks = blocks / ((nv + OWN - 1) / OWN);
    const size_t at =
        ((size_t)(k / OWN) * chunks * OWN + k % OWN) * d + idx % d;
    for (int c = 0; c < chunks; ++c) s += partial[at + (size_t)c * OWN * d];
  }
  d_protos[idx] = s;
}

template <int F, template <int, int> class Launch, typename... Args>
int dispatch_d(int d, Args... args) {
  switch (d) {
    case 16: Launch<16, F>::run(args...); break;
    case 32: Launch<32, F>::run(args...); break;
    case 64: Launch<64, F>::run(args...); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int D, int F, bool SQUARE>
void launch_stats_tile(const float* emb, const int* pix_lab, const int* own,
                       const int* pix_tag, const float* protos,
                       const int* proto_lab, const int* proto_tag,
                       const int* proto_valid, const int* num_valid, int n,
                       int p, float kappa_a, float kappa_o, float* out,
                       cudaStream_t stream) {
  constexpr int smem = (int)sizeof(PixelTileSmem<D>);  // above 48 KB
  cudaFuncSetAttribute(stats_tile_kernel<D, F, SQUARE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stats_tile_kernel<D, F, SQUARE><<<(n + OWN - 1) / OWN, TILE_THREADS, smem,
                                    stream>>>(
      emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag, proto_valid,
      num_valid, n, p, kappa_a, kappa_o, out);
}

template <int D, int F>
struct LaunchStatsTiled {
  static void run(const float* emb, const int* pix_lab, const int* own,
                  const int* pix_tag, const float* protos,
                  const int* proto_lab, const int* proto_tag,
                  const int* proto_valid, const int* num_valid, int n, int p,
                  float kappa_a, float kappa_o, int square, float* out,
                  cudaStream_t stream) {
    if constexpr (F == JOINT) {  // SQUARE needs two concentrations
      if (square) {
        launch_stats_tile<D, F, true>(emb, pix_lab, own, pix_tag, protos,
                                      proto_lab, proto_tag, proto_valid,
                                      num_valid, n, p, kappa_a, kappa_o,
                                      out, stream);
        return;
      }
    }
    launch_stats_tile<D, F, false>(emb, pix_lab, own, pix_tag, protos,
                                   proto_lab, proto_tag, proto_valid,
                                   num_valid, n, p, kappa_a, kappa_o, out,
                                   stream);
  }
};

template <int D, int F, bool DP>
void launch_grad_tile(int blocks, const float* emb, const int* pix_lab,
                      const int* own, const int* pix_tag,
                      const float* protos, const int* proto_lab,
                      const int* proto_tag, const int* proto_valid,
                      const int* num_valid, int n, int p, float kappa_a,
                      float kappa_o, int square, const float* grads,
                      float* out, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(TileSmem<D, F, DP>);  // above 48 KB
  cudaFuncSetAttribute(grad_tile_kernel<D, F, DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  grad_tile_kernel<D, F, DP><<<blocks, TILE_THREADS, smem, stream>>>(
      emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag, proto_valid,
      num_valid, n, p, kappa_a, kappa_o, square, grads, out);
}

template <int D, int F>
struct LaunchGradEmbTiled {
  static void run(const float* emb, const int* pix_lab, const int* own,
                  const int* pix_tag, const float* protos,
                  const int* proto_lab, const int* proto_tag,
                  const int* proto_valid, const int* num_valid, int n, int p,
                  float kappa_a, float kappa_o, int square,
                  const float* grads, float* d_emb, cudaStream_t stream) {
    launch_grad_tile<D, F, false>(
        (n + OWN - 1) / OWN, emb, pix_lab, own, pix_tag, protos, proto_lab,
        proto_tag, proto_valid, num_valid, n, p, kappa_a, kappa_o, square,
        grads, d_emb, stream);
  }
};

template <int D, int F>
struct LaunchGradProtoTiled {
  static void run(const float* emb, const int* pix_lab, const int* own,
                  const int* pix_tag, const float* protos,
                  const int* proto_lab, const int* proto_tag,
                  const int* proto_valid, const int* num_valid, int n, int p,
                  float kappa_a, float kappa_o, int square,
                  const float* grads, float* partial, int blocks,
                  float* d_protos, cudaStream_t stream) {
    launch_grad_tile<D, F, true>(
        blocks, emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
        proto_valid, num_valid, n, p, kappa_a, kappa_o, square, grads,
        partial, stream);
    const size_t total = (size_t)p * D;
    reduce_tiles_kernel<<<(int)((total + REDUCE_THREADS - 1) /
                                REDUCE_THREADS),
                          REDUCE_THREADS, 0, stream>>>(
        partial, num_valid, p, D, blocks, d_protos);
  }
};

}  // namespace

extern "C" {

// out: [6, n] rows own_a, same_a, diff_a, own_o, same_o, diff_o.
int segsort_joint_stats(const float* emb, const int* pix_lab, const int* own,
                        const int* pix_tag, const float* protos,
                        const int* proto_lab, const int* proto_tag,
                        const int* proto_valid, const int* num_valid, int n,
                        int p, int d, float kappa_a, float kappa_o,
                        int square, float* out, void* stream) {
  if (n == 0) return 0;
  return dispatch_d<JOINT, LaunchStatsTiled>(
      d, emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
      proto_valid, num_valid, n, p, kappa_a, kappa_o, square, out,
      (cudaStream_t)stream);
}

// grads: [6, n] cotangents of the six rows of segsort_joint_stats.
int segsort_joint_grad_emb(const float* emb, const int* pix_lab,
                           const int* own, const int* pix_tag,
                           const float* protos, const int* proto_lab,
                           const int* proto_tag, const int* proto_valid,
                           const int* num_valid, int n, int p, int d,
                           float kappa_a, float kappa_o, int square,
                           const float* grads, float* d_emb, void* stream) {
  if (n == 0) return 0;
  return dispatch_d<JOINT, LaunchGradEmbTiled>(
      d, emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
      proto_valid, num_valid, n, p, kappa_a, kappa_o, square, grads, d_emb,
      (cudaStream_t)stream);
}

// partial: scratch [blocks, 128, d], blocks >= ceil(p / 128): the grid of
// the dP kernel, split on the device into valid prototype tiles x pixel
// chunks.
int segsort_joint_grad_proto(const float* emb, const int* pix_lab,
                             const int* own, const int* pix_tag,
                             const float* protos, const int* proto_lab,
                             const int* proto_tag, const int* proto_valid,
                             const int* num_valid, int n, int p, int d,
                             float kappa_a, float kappa_o, int square,
                             const float* grads, float* partial, int blocks,
                             float* d_protos, void* stream) {
  if (p == 0) return 0;
  if (blocks < (p + OWN - 1) / OWN) return (int)cudaErrorInvalidValue;
  return dispatch_d<JOINT, LaunchGradProtoTiled>(
      d, emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
      proto_valid, num_valid, n, p, kappa_a, kappa_o, square, grads,
      partial, blocks, d_protos, (cudaStream_t)stream);
}

// out: [3, n] rows own, same, diff at concentration kappa.
int segsort_hard_stats(const float* emb, const int* pix_lab, const int* own,
                       const float* protos, const int* proto_lab,
                       const int* num_valid, int n, int p, int d,
                       float kappa, float* out, void* stream) {
  if (n == 0) return 0;
  return dispatch_d<HARD, LaunchStatsTiled>(
      d, emb, pix_lab, own, (const int*)nullptr, protos, proto_lab,
      (const int*)nullptr, (const int*)nullptr, num_valid, n, p, kappa, 0.f,
      0, out, (cudaStream_t)stream);
}

// grads: [3, n] cotangents of the three rows of segsort_hard_stats.
int segsort_hard_grad_emb(const float* emb, const int* pix_lab,
                          const int* own, const float* protos,
                          const int* proto_lab, const int* num_valid, int n,
                          int p, int d, float kappa, const float* grads,
                          float* d_emb, void* stream) {
  if (n == 0) return 0;
  return dispatch_d<HARD, LaunchGradEmbTiled>(
      d, emb, pix_lab, own, (const int*)nullptr, protos, proto_lab,
      (const int*)nullptr, (const int*)nullptr, num_valid, n, p, kappa, 0.f,
      0, grads, d_emb, (cudaStream_t)stream);
}

// partial: scratch [blocks, 128, d], blocks >= ceil(p / 128), as for
// segsort_joint_grad_proto.
int segsort_hard_grad_proto(const float* emb, const int* pix_lab,
                            const int* own, const float* protos,
                            const int* proto_lab, const int* num_valid,
                            int n, int p, int d, float kappa,
                            const float* grads, float* partial, int blocks,
                            float* d_protos, void* stream) {
  if (p == 0) return 0;
  if (blocks < (p + OWN - 1) / OWN) return (int)cudaErrorInvalidValue;
  return dispatch_d<HARD, LaunchGradProtoTiled>(
      d, emb, pix_lab, own, (const int*)nullptr, protos, proto_lab,
      (const int*)nullptr, (const int*)nullptr, num_valid, n, p, kappa, 0.f,
      0, grads, partial, blocks, d_protos, (cudaStream_t)stream);
}

// out: [3, n] rows own, same, diff (tag sets intersect / are disjoint) at
// concentration kappa. pix_tag / proto_tag are class bitwords.
int segsort_set_stats(const float* emb, const int* pix_tag, const int* own,
                      const float* protos, const int* proto_tag,
                      const int* proto_valid, const int* num_valid, int n,
                      int p, int d, float kappa, float* out, void* stream) {
  if (n == 0) return 0;
  return dispatch_d<SET, LaunchStatsTiled>(
      d, emb, (const int*)nullptr, own, pix_tag, protos, (const int*)nullptr,
      proto_tag, proto_valid, num_valid, n, p, kappa, 0.f, 0, out,
      (cudaStream_t)stream);
}

// grads: [3, n] cotangents of the three rows of segsort_set_stats.
int segsort_set_grad_emb(const float* emb, const int* pix_tag,
                         const int* own, const float* protos,
                         const int* proto_tag, const int* proto_valid,
                         const int* num_valid, int n, int p, int d,
                         float kappa, const float* grads, float* d_emb,
                         void* stream) {
  if (n == 0) return 0;
  return dispatch_d<SET, LaunchGradEmbTiled>(
      d, emb, (const int*)nullptr, own, pix_tag, protos, (const int*)nullptr,
      proto_tag, proto_valid, num_valid, n, p, kappa, 0.f, 0, grads, d_emb,
      (cudaStream_t)stream);
}

// partial: scratch [blocks, 128, d], blocks >= ceil(p / 128), as for
// segsort_joint_grad_proto.
int segsort_set_grad_proto(const float* emb, const int* pix_tag,
                           const int* own, const float* protos,
                           const int* proto_tag, const int* proto_valid,
                           const int* num_valid, int n, int p, int d,
                           float kappa, const float* grads, float* partial,
                           int blocks, float* d_protos, void* stream) {
  if (p == 0) return 0;
  if (blocks < (p + OWN - 1) / OWN) return (int)cudaErrorInvalidValue;
  return dispatch_d<SET, LaunchGradProtoTiled>(
      d, emb, (const int*)nullptr, own, pix_tag, protos, (const int*)nullptr,
      proto_tag, proto_valid, num_valid, n, p, kappa, 0.f, 0, grads,
      partial, blocks, d_protos, (cudaStream_t)stream);
}

}  // extern "C"
