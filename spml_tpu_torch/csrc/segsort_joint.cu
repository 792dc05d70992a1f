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
// them to one launch each (two for dP) with no host round trip. These
// kernels use float32 FMAs on the CUDA cores (67 TFLOP/s), not the tensor
// cores: the logits feed exp(kappa l), which amplifies TF32 or bf16
// operand rounding.
//
// Design. The [N, P] similarity matrix never reaches device memory.
//   stats, dE: one thread per pixel row keeps E[n] (and, for dE, dE[n]) in
//     registers; the block stages tiles of TP prototypes, labels and tag
//     bits in shared memory, read as warp-wide broadcasts. The loop stops
//     at num_valid, read from device memory, so the host never waits for
//     it. The stats kernel sums each tile into its own partials before
//     adding them to the running sums (two-level summation keeps the
//     6144-term sums accurate to ~1e-6).
//   dP: one thread per prototype row keeps P[k] and dP[k] in registers;
//     blocks also split the pixels into chunks (`chunk` rows, 2048 from
//     the wrapper), so that a few hundred prototypes still fill the 132
//     SMs. Each chunk writes its partial dP to scratch and a second kernel
//     adds the chunks in a fixed order: the result does not depend on the
//     run (no float atomics).
//   Every kernel computes the dot products in the same order, so the
//   three of a family agree on each logit bit for bit.
// Left for later: wgmma / TMA tiles, bf16 operands, skipping pixels whose
// cotangents are all zero.

#include <cuda_runtime.h>

namespace {

constexpr int JOINT = 0;
constexpr int HARD = 1;
constexpr int SET = 2;  // rows carry no label: tag bitwords and validity

__host__ __device__ constexpr int n_stats(int family) {
  return family == JOINT ? 6 : 3;
}

constexpr int THREADS = 128;  // pixels (stats, dE) or prototypes (dP) a block
constexpr int TP = 64;        // prototypes per shared tile (stats, dE)
constexpr int TN = 64;        // pixels per shared tile (dP)
constexpr int REDUCE_THREADS = 256;

// Four independent FMA chains (lanes d mod 4), added pairwise at the end:
// shorter chains round less than one 64-long chain (exp(12 l) turns a
// logit error into 12x the relative error), and they overlap in the
// pipeline.
template <int D>
__device__ __forceinline__ float dot_row(const float (&r)[D],
                                         const float* __restrict__ s) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(s + d);
    a0 = fmaf(r[d], v.x, a0);
    a1 = fmaf(r[d + 1], v.y, a1);
    a2 = fmaf(r[d + 2], v.z, a2);
    a3 = fmaf(r[d + 3], v.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

template <int D>
__device__ __forceinline__ void load_row(float (&r)[D],
                                         const float* __restrict__ g) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(g + d);
    r[d] = v.x;
    r[d + 1] = v.y;
    r[d + 2] = v.z;
    r[d + 3] = v.w;
  }
}

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
// SET (own, same, diff by tag set).
template <int F>
__device__ __forceinline__ void add_pair(float (&acc)[n_stats(F)],
                                         const PairMasks& m, float sa,
                                         float so) {
  acc[0] += m.own ? sa : 0.f;
  if constexpr (F == SET) {
    acc[1] += m.same_o ? sa : 0.f;
    acc[2] += m.diff_o ? sa : 0.f;
  } else {
    acc[1] += m.same_a ? sa : 0.f;
    acc[2] += m.diff_a ? sa : 0.f;
  }
  if constexpr (F == JOINT) {
    acc[3] += m.own ? so : 0.f;
    acc[4] += m.same_o ? so : 0.f;
    acc[5] += m.diff_o ? so : 0.f;
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

// Stages prototypes [t0, t0 + cnt) of a valid-first sorted set (HARD reads
// no tag bits or validity, SET no label).
template <int D, int F>
__device__ __forceinline__ void stage_protos(
    float* sp, int* slab, int* stag, int* sval, const float* protos,
    const int* proto_lab, const int* proto_tag, const int* proto_valid,
    int t0, int cnt) {
  const float4* src = reinterpret_cast<const float4*>(protos + (size_t)t0 * D);
  float4* dst = reinterpret_cast<float4*>(sp);
  for (int i = threadIdx.x; i < cnt * D / 4; i += blockDim.x) dst[i] = src[i];
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    if constexpr (F == SET) {
      slab[i] = -1;
    } else {
      slab[i] = proto_lab[t0 + i];
    }
    if constexpr (F != HARD) {
      stag[i] = proto_tag[t0 + i];
      sval[i] = proto_valid[t0 + i];
    } else {
      stag[i] = 0;
      sval[i] = 0;
    }
  }
}

template <int D, int F>
__global__ void __launch_bounds__(THREADS) stats_kernel(
    const float* __restrict__ emb, const int* __restrict__ pix_lab,
    const int* __restrict__ own, const int* __restrict__ pix_tag,
    const float* __restrict__ protos, const int* __restrict__ proto_lab,
    const int* __restrict__ proto_tag, const int* __restrict__ proto_valid,
    const int* __restrict__ num_valid, int n, int p, float kappa_a,
    float kappa_o, int square, float* __restrict__ out) {
  constexpr int NS = n_stats(F);
  __shared__ __align__(16) float sp[TP * D];
  __shared__ int slab[TP], stag[TP], sval[TP];
  const int row = blockIdx.x * THREADS + threadIdx.x;
  const bool live = row < n;
  float e[D];
  int lab = -1, own_k = -1, tag = 0;
  if (live) {
    load_row<D>(e, emb + (size_t)row * D);
    if constexpr (F != SET) lab = pix_lab[row];
    own_k = own[row];
    if constexpr (F != HARD) tag = pix_tag[row];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) e[d] = 0.f;
  }
  const int nv = min(*num_valid, p);
  float acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.f;
  for (int t0 = 0; t0 < nv; t0 += TP) {
    const int cnt = min(TP, nv - t0);
    __syncthreads();
    stage_protos<D, F>(sp, slab, stag, sval, protos, proto_lab, proto_tag,
                       proto_valid, t0, cnt);
    __syncthreads();
    float part[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) part[s] = 0.f;
    for (int j = 0; j < cnt; ++j) {
      float sa, so;
      sims<F>(dot_row<D>(e, sp + j * D), kappa_a, kappa_o, square, sa, so);
      const PairMasks m = pair_masks(t0 + j, own_k, lab, tag, slab[j],
                                     stag[j], sval[j]);
      add_pair<F>(part, m, sa, so);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] += part[s];
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < NS; ++s) out[(size_t)s * n + row] = acc[s];
  }
}

template <int D, int F>
__global__ void __launch_bounds__(THREADS) grad_emb_kernel(
    const float* __restrict__ emb, const int* __restrict__ pix_lab,
    const int* __restrict__ own, const int* __restrict__ pix_tag,
    const float* __restrict__ protos, const int* __restrict__ proto_lab,
    const int* __restrict__ proto_tag, const int* __restrict__ proto_valid,
    const int* __restrict__ num_valid, int n, int p, float kappa_a,
    float kappa_o, int square, const float* __restrict__ grads,
    float* __restrict__ d_emb) {
  constexpr int NS = n_stats(F);
  __shared__ __align__(16) float sp[TP * D];
  __shared__ int slab[TP], stag[TP], sval[TP];
  const int row = blockIdx.x * THREADS + threadIdx.x;
  const bool live = row < n;
  float e[D], acc[D];
  float g[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) g[s] = 0.f;
  int lab = -1, own_k = -1, tag = 0;
  if (live) {
    load_row<D>(e, emb + (size_t)row * D);
    if constexpr (F != SET) lab = pix_lab[row];
    own_k = own[row];
    if constexpr (F != HARD) tag = pix_tag[row];
#pragma unroll
    for (int s = 0; s < NS; ++s) g[s] = grads[(size_t)s * n + row];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) e[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const int nv = min(*num_valid, p);
  for (int t0 = 0; t0 < nv; t0 += TP) {
    const int cnt = min(TP, nv - t0);
    __syncthreads();
    stage_protos<D, F>(sp, slab, stag, sval, protos, proto_lab, proto_tag,
                       proto_valid, t0, cnt);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float* pk = sp + j * D;
      float sa, so;
      sims<F>(dot_row<D>(e, pk), kappa_a, kappa_o, square, sa, so);
      const PairMasks m = pair_masks(t0 + j, own_k, lab, tag, slab[j],
                                     stag[j], sval[j]);
      const float c = pair_coeff<F>(m, g, sa, so, kappa_a, kappa_o);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 v = *reinterpret_cast<const float4*>(pk + d);
        acc[d] = fmaf(c, v.x, acc[d]);
        acc[d + 1] = fmaf(c, v.y, acc[d + 1]);
        acc[d + 2] = fmaf(c, v.z, acc[d + 2]);
        acc[d + 3] = fmaf(c, v.w, acc[d + 3]);
      }
    }
  }
  if (live) {
    float4* dst = reinterpret_cast<float4*>(d_emb + (size_t)row * D);
#pragma unroll
    for (int d = 0; d < D; d += 4)
      dst[d / 4] = make_float4(acc[d], acc[d + 1], acc[d + 2], acc[d + 3]);
  }
}

// grid (ceil(P / THREADS), n_chunks): partial[c][k] = sum over the pixels
// [c * chunk, (c + 1) * chunk) of c[n, k] E[n].
template <int D, int F>
__global__ void __launch_bounds__(THREADS) grad_proto_kernel(
    const float* __restrict__ emb, const int* __restrict__ pix_lab,
    const int* __restrict__ own, const int* __restrict__ pix_tag,
    const float* __restrict__ protos, const int* __restrict__ proto_lab,
    const int* __restrict__ proto_tag, const int* __restrict__ proto_valid,
    const int* __restrict__ num_valid, int n, int p, float kappa_a,
    float kappa_o, int square, const float* __restrict__ grads, int chunk,
    float* __restrict__ partial) {
  constexpr int NS = n_stats(F);
  __shared__ __align__(16) float se[TN * D];
  __shared__ int slab[TN], sown[TN], stag[TN];
  __shared__ float sg[NS][TN];
  const int nv = min(*num_valid, p);
  const int k0 = blockIdx.x * THREADS;
  if (k0 >= nv) return;  // uniform over the block
  const int k = k0 + threadIdx.x;
  const bool live = k < nv;
  float pr[D], acc[D];
  int plab = -1, ptag = 0, pval = 0;
  if (live) {
    load_row<D>(pr, protos + (size_t)k * D);
    if constexpr (F != SET) plab = proto_lab[k];
    if constexpr (F != HARD) {
      ptag = proto_tag[k];
      pval = proto_valid[k];
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) pr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(c0 + chunk, n);
  for (int t0 = c0; t0 < c1; t0 += TN) {
    const int cnt = min(TN, c1 - t0);
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(emb + (size_t)t0 * D);
    float4* dst = reinterpret_cast<float4*>(se);
    for (int i = threadIdx.x; i < cnt * D / 4; i += THREADS) dst[i] = src[i];
    for (int i = threadIdx.x; i < cnt; i += THREADS) {
      if constexpr (F == SET) {
        slab[i] = -1;
      } else {
        slab[i] = pix_lab[t0 + i];
      }
      sown[i] = own[t0 + i];
      stag[i] = F != HARD ? pix_tag[t0 + i] : 0;
#pragma unroll
      for (int s = 0; s < NS; ++s) sg[s][i] = grads[(size_t)s * n + t0 + i];
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const float* ei = se + i * D;
      float sa, so;
      sims<F>(dot_row<D>(pr, ei), kappa_a, kappa_o, square, sa, so);
      const PairMasks m = pair_masks(k, sown[i], slab[i], stag[i], plab,
                                     ptag, pval);
      float gi[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) gi[s] = sg[s][i];
      const float c = pair_coeff<F>(m, gi, sa, so, kappa_a, kappa_o);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 v = *reinterpret_cast<const float4*>(ei + d);
        acc[d] = fmaf(c, v.x, acc[d]);
        acc[d + 1] = fmaf(c, v.y, acc[d + 1]);
        acc[d + 2] = fmaf(c, v.z, acc[d + 2]);
        acc[d + 3] = fmaf(c, v.w, acc[d + 3]);
      }
    }
  }
  if (live) {
    float4* dst = reinterpret_cast<float4*>(
        partial + ((size_t)blockIdx.y * p + k) * D);
#pragma unroll
    for (int d = 0; d < D; d += 4)
      dst[d / 4] = make_float4(acc[d], acc[d + 1], acc[d + 2], acc[d + 3]);
  }
}

// d_protos[k][d] = sum over chunks, in chunk order, for k < num_valid;
// 0 past it.
__global__ void reduce_chunks_kernel(const float* __restrict__ partial,
                                     const int* __restrict__ num_valid,
                                     int p, int d, int n_chunks,
                                     float* __restrict__ d_protos) {
  const size_t idx = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  const size_t total = (size_t)p * d;
  if (idx >= total) return;
  const int nv = min(*num_valid, p);
  float s = 0.f;
  if ((int)(idx / d) < nv) {
    for (int c = 0; c < n_chunks; ++c) s += partial[(size_t)c * total + idx];
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

template <int D, int F>
struct LaunchStats {
  static void run(const float* emb, const int* pix_lab, const int* own,
                  const int* pix_tag, const float* protos,
                  const int* proto_lab, const int* proto_tag,
                  const int* proto_valid, const int* num_valid, int n, int p,
                  float kappa_a, float kappa_o, int square, float* out,
                  cudaStream_t stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    stats_kernel<D, F><<<blocks, THREADS, 0, stream>>>(
        emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
        proto_valid, num_valid, n, p, kappa_a, kappa_o, square, out);
  }
};

template <int D, int F>
struct LaunchGradEmb {
  static void run(const float* emb, const int* pix_lab, const int* own,
                  const int* pix_tag, const float* protos,
                  const int* proto_lab, const int* proto_tag,
                  const int* proto_valid, const int* num_valid, int n, int p,
                  float kappa_a, float kappa_o, int square,
                  const float* grads, float* d_emb, cudaStream_t stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    grad_emb_kernel<D, F><<<blocks, THREADS, 0, stream>>>(
        emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
        proto_valid, num_valid, n, p, kappa_a, kappa_o, square, grads,
        d_emb);
  }
};

template <int D, int F>
struct LaunchGradProto {
  static void run(const float* emb, const int* pix_lab, const int* own,
                  const int* pix_tag, const float* protos,
                  const int* proto_lab, const int* proto_tag,
                  const int* proto_valid, const int* num_valid, int n, int p,
                  float kappa_a, float kappa_o, int square,
                  const float* grads, int chunk, float* partial,
                  int n_chunks, float* d_protos, cudaStream_t stream) {
    if (n_chunks > 0) {
      const dim3 grid((p + THREADS - 1) / THREADS, n_chunks);
      grad_proto_kernel<D, F><<<grid, THREADS, 0, stream>>>(
          emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
          proto_valid, num_valid, n, p, kappa_a, kappa_o, square, grads,
          chunk, partial);
    }
    const size_t total = (size_t)p * D;
    const int blocks = (int)((total + REDUCE_THREADS - 1) / REDUCE_THREADS);
    reduce_chunks_kernel<<<blocks, REDUCE_THREADS, 0, stream>>>(
        partial, num_valid, p, D, n_chunks, d_protos);
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
  return dispatch_d<JOINT, LaunchStats>(
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
  return dispatch_d<JOINT, LaunchGradEmb>(
      d, emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
      proto_valid, num_valid, n, p, kappa_a, kappa_o, square, grads, d_emb,
      (cudaStream_t)stream);
}

// partial: scratch [n_chunks, p, d], n_chunks = ceil(n / chunk).
int segsort_joint_grad_proto(const float* emb, const int* pix_lab,
                             const int* own, const int* pix_tag,
                             const float* protos, const int* proto_lab,
                             const int* proto_tag, const int* proto_valid,
                             const int* num_valid, int n, int p, int d,
                             float kappa_a, float kappa_o, int square,
                             const float* grads, int chunk, float* partial,
                             int n_chunks, float* d_protos, void* stream) {
  if (p == 0) return 0;
  return dispatch_d<JOINT, LaunchGradProto>(
      d, emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
      proto_valid, num_valid, n, p, kappa_a, kappa_o, square, grads, chunk,
      partial, n_chunks, d_protos, (cudaStream_t)stream);
}

// out: [3, n] rows own, same, diff at concentration kappa.
int segsort_hard_stats(const float* emb, const int* pix_lab, const int* own,
                       const float* protos, const int* proto_lab,
                       const int* num_valid, int n, int p, int d,
                       float kappa, float* out, void* stream) {
  if (n == 0) return 0;
  return dispatch_d<HARD, LaunchStats>(
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
  return dispatch_d<HARD, LaunchGradEmb>(
      d, emb, pix_lab, own, (const int*)nullptr, protos, proto_lab,
      (const int*)nullptr, (const int*)nullptr, num_valid, n, p, kappa, 0.f,
      0, grads, d_emb, (cudaStream_t)stream);
}

// partial: scratch [n_chunks, p, d], n_chunks = ceil(n / chunk).
int segsort_hard_grad_proto(const float* emb, const int* pix_lab,
                            const int* own, const float* protos,
                            const int* proto_lab, const int* num_valid,
                            int n, int p, int d, float kappa,
                            const float* grads, int chunk, float* partial,
                            int n_chunks, float* d_protos, void* stream) {
  if (p == 0) return 0;
  return dispatch_d<HARD, LaunchGradProto>(
      d, emb, pix_lab, own, (const int*)nullptr, protos, proto_lab,
      (const int*)nullptr, (const int*)nullptr, num_valid, n, p, kappa, 0.f,
      0, grads, chunk, partial, n_chunks, d_protos, (cudaStream_t)stream);
}

// out: [3, n] rows own, same, diff (tag sets intersect / are disjoint) at
// concentration kappa. pix_tag / proto_tag are class bitwords.
int segsort_set_stats(const float* emb, const int* pix_tag, const int* own,
                      const float* protos, const int* proto_tag,
                      const int* proto_valid, const int* num_valid, int n,
                      int p, int d, float kappa, float* out, void* stream) {
  if (n == 0) return 0;
  return dispatch_d<SET, LaunchStats>(
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
  return dispatch_d<SET, LaunchGradEmb>(
      d, emb, (const int*)nullptr, own, pix_tag, protos, (const int*)nullptr,
      proto_tag, proto_valid, num_valid, n, p, kappa, 0.f, 0, grads, d_emb,
      (cudaStream_t)stream);
}

// partial: scratch [n_chunks, p, d], n_chunks = ceil(n / chunk).
int segsort_set_grad_proto(const float* emb, const int* pix_tag,
                           const int* own, const float* protos,
                           const int* proto_tag, const int* proto_valid,
                           const int* num_valid, int n, int p, int d,
                           float kappa, const float* grads, int chunk,
                           float* partial, int n_chunks, float* d_protos,
                           void* stream) {
  if (p == 0) return 0;
  return dispatch_d<SET, LaunchGradProto>(
      d, emb, (const int*)nullptr, own, pix_tag, protos, (const int*)nullptr,
      proto_tag, proto_valid, num_valid, n, p, kappa, 0.f, 0, grads, chunk,
      partial, n_chunks, d_protos, (cudaStream_t)stream);
}

}  // extern "C"
