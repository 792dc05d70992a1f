// Joint SegSort statistics and their gradients: the fused sem_ann + sem_occ
// loss sweep of the SPML train step, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of spml_tpu/ops/pallas/segsort_loss.py:
//   K1 segsort_joint_stats      <- _joint_stats_kernel
//   K2 segsort_joint_grad_emb   <- _joint_grad_kernel(transpose=False)
//   K3 segsort_joint_grad_proto <- _joint_grad_kernel(transpose=True)
//
// For N pixels and the first num_valid of P prototypes (sorted valid-first
// by the wrapper; rows past num_valid contribute exactly zero), with
// l = E[n].P[k], s_a = exp(kappa_a l), s_o = exp(kappa_o l) (s_a^2 when
// kappa_o == 2 kappa_a, as the TPU kernel does):
//   K1: six row sums over k of s_a / s_o under the own, same-label,
//       different-label, tag-intersect and tag-disjoint masks;
//   K2: dE[n] = sum_k c[n,k] P[k],   c = kappa_a s_a g_a + kappa_o s_o g_o,
//       g_a / g_o the incoming row cotangents picked by the same masks;
//   K3: dP[k] = sum_n c[n,k] E[n].
//
// What bounds them on this card: operations, not bytes. Each (pixel,
// prototype) pair costs a D-long dot product (2D flops), one or two exps
// and the masked sums; the inputs are O((N + P) D) and read once. At the
// flagship shapes (N = 131072, P = 6144, D = 64) one sweep over a full
// prototype set is ~1e11 flops against ~40 MB of inputs. These kernels use
// float32 FMAs on the CUDA cores (67 TFLOP/s), not the tensor cores: the
// logits feed exp(12 l), which amplifies TF32 or bf16 operand rounding.
//
// Design. The [N, P] similarity matrix never reaches device memory.
//   K1, K2: one thread per pixel row keeps E[n] (and, in K2, dE[n]) in
//     registers; the block stages tiles of TP prototypes, labels and tag
//     bits in shared memory, read as warp-wide broadcasts. The loop stops
//     at num_valid, read from device memory, so the host never waits for
//     it. K1 sums each tile into its own partials before adding them to
//     the running sums (two-level summation keeps the 6144-term sums
//     accurate to ~1e-6).
//   K3: one thread per prototype row keeps P[k] and dP[k] in registers;
//     blocks also split the pixels into chunks (`chunk` rows, 2048 from
//     the wrapper), so that a few
//     hundred prototypes still fill the 132 SMs. Each chunk writes its
//     partial dP to scratch and a second kernel adds the chunks in a fixed
//     order: the result does not depend on the run (no float atomics).
//   Every kernel computes the dot products in the same order, so the
//   three agree on each logit bit for bit.
// Left for later: wgmma / TMA tiles, bf16 operands, skipping pixels whose
// cotangents are all zero.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // pixels (K1, K2) or prototypes (K3) a block
constexpr int TP = 64;        // prototypes per shared tile (K1, K2)
constexpr int TN = 64;        // pixels per shared tile (K3)
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

__device__ __forceinline__ void sims(float l, float kappa_a, float kappa_o,
                                     int square, float& sa, float& so) {
  sa = expf(l * kappa_a);
  so = square ? sa * sa : expf(l * kappa_o);
}

// Stages prototypes [t0, t0 + cnt) of a valid-first sorted set.
template <int D>
__device__ __forceinline__ void stage_protos(
    float* sp, int* slab, int* stag, int* sval, const float* protos,
    const int* proto_lab, const int* proto_tag, const int* proto_valid,
    int t0, int cnt) {
  const float4* src = reinterpret_cast<const float4*>(protos + (size_t)t0 * D);
  float4* dst = reinterpret_cast<float4*>(sp);
  for (int i = threadIdx.x; i < cnt * D / 4; i += blockDim.x) dst[i] = src[i];
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    slab[i] = proto_lab[t0 + i];
    stag[i] = proto_tag[t0 + i];
    sval[i] = proto_valid[t0 + i];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) joint_stats_kernel(
    const float* __restrict__ emb, const int* __restrict__ pix_lab,
    const int* __restrict__ own, const int* __restrict__ pix_tag,
    const float* __restrict__ protos, const int* __restrict__ proto_lab,
    const int* __restrict__ proto_tag, const int* __restrict__ proto_valid,
    const int* __restrict__ num_valid, int n, int p, float kappa_a,
    float kappa_o, int square, float* __restrict__ out) {
  __shared__ __align__(16) float sp[TP * D];
  __shared__ int slab[TP], stag[TP], sval[TP];
  const int row = blockIdx.x * THREADS + threadIdx.x;
  const bool live = row < n;
  float e[D];
  int lab = -1, own_k = -1, tag = 0;
  if (live) {
    load_row<D>(e, emb + (size_t)row * D);
    lab = pix_lab[row];
    own_k = own[row];
    tag = pix_tag[row];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) e[d] = 0.f;
  }
  const int nv = min(*num_valid, p);
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < nv; t0 += TP) {
    const int cnt = min(TP, nv - t0);
    __syncthreads();
    stage_protos<D>(sp, slab, stag, sval, protos, proto_lab, proto_tag,
                    proto_valid, t0, cnt);
    __syncthreads();
    float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < cnt; ++j) {
      float sa, so;
      sims(dot_row<D>(e, sp + j * D), kappa_a, kappa_o, square, sa, so);
      const PairMasks m = pair_masks(t0 + j, own_k, lab, tag, slab[j],
                                     stag[j], sval[j]);
      part[0] += m.own ? sa : 0.f;
      part[1] += m.same_a ? sa : 0.f;
      part[2] += m.diff_a ? sa : 0.f;
      part[3] += m.own ? so : 0.f;
      part[4] += m.same_o ? so : 0.f;
      part[5] += m.diff_o ? so : 0.f;
    }
#pragma unroll
    for (int s = 0; s < 6; ++s) acc[s] += part[s];
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < 6; ++s) out[(size_t)s * n + row] = acc[s];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) joint_grad_emb_kernel(
    const float* __restrict__ emb, const int* __restrict__ pix_lab,
    const int* __restrict__ own, const int* __restrict__ pix_tag,
    const float* __restrict__ protos, const int* __restrict__ proto_lab,
    const int* __restrict__ proto_tag, const int* __restrict__ proto_valid,
    const int* __restrict__ num_valid, int n, int p, float kappa_a,
    float kappa_o, int square, const float* __restrict__ grads,
    float* __restrict__ d_emb) {
  __shared__ __align__(16) float sp[TP * D];
  __shared__ int slab[TP], stag[TP], sval[TP];
  const int row = blockIdx.x * THREADS + threadIdx.x;
  const bool live = row < n;
  float e[D], acc[D];
  float g[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int lab = -1, own_k = -1, tag = 0;
  if (live) {
    load_row<D>(e, emb + (size_t)row * D);
    lab = pix_lab[row];
    own_k = own[row];
    tag = pix_tag[row];
#pragma unroll
    for (int s = 0; s < 6; ++s) g[s] = grads[(size_t)s * n + row];
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
    stage_protos<D>(sp, slab, stag, sval, protos, proto_lab, proto_tag,
                    proto_valid, t0, cnt);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float* pk = sp + j * D;
      float sa, so;
      sims(dot_row<D>(e, pk), kappa_a, kappa_o, square, sa, so);
      const PairMasks m = pair_masks(t0 + j, own_k, lab, tag, slab[j],
                                     stag[j], sval[j]);
      const float ga = (m.own ? g[0] : 0.f) + (m.same_a ? g[1] : 0.f) +
                       (m.diff_a ? g[2] : 0.f);
      const float go = (m.own ? g[3] : 0.f) + (m.same_o ? g[4] : 0.f) +
                       (m.diff_o ? g[5] : 0.f);
      const float c = kappa_a * sa * ga + kappa_o * so * go;
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
template <int D>
__global__ void __launch_bounds__(THREADS) joint_grad_proto_kernel(
    const float* __restrict__ emb, const int* __restrict__ pix_lab,
    const int* __restrict__ own, const int* __restrict__ pix_tag,
    const float* __restrict__ protos, const int* __restrict__ proto_lab,
    const int* __restrict__ proto_tag, const int* __restrict__ proto_valid,
    const int* __restrict__ num_valid, int n, int p, float kappa_a,
    float kappa_o, int square, const float* __restrict__ grads, int chunk,
    float* __restrict__ partial) {
  __shared__ __align__(16) float se[TN * D];
  __shared__ int slab[TN], sown[TN], stag[TN];
  __shared__ float sg[6][TN];
  const int nv = min(*num_valid, p);
  const int k0 = blockIdx.x * THREADS;
  if (k0 >= nv) return;  // uniform over the block
  const int k = k0 + threadIdx.x;
  const bool live = k < nv;
  float pr[D], acc[D];
  int plab = -1, ptag = 0, pval = 0;
  if (live) {
    load_row<D>(pr, protos + (size_t)k * D);
    plab = proto_lab[k];
    ptag = proto_tag[k];
    pval = proto_valid[k];
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
      slab[i] = pix_lab[t0 + i];
      sown[i] = own[t0 + i];
      stag[i] = pix_tag[t0 + i];
#pragma unroll
      for (int s = 0; s < 6; ++s) sg[s][i] = grads[(size_t)s * n + t0 + i];
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const float* ei = se + i * D;
      float sa, so;
      sims(dot_row<D>(pr, ei), kappa_a, kappa_o, square, sa, so);
      const PairMasks m = pair_masks(k, sown[i], slab[i], stag[i], plab,
                                     ptag, pval);
      const float ga = (m.own ? sg[0][i] : 0.f) + (m.same_a ? sg[1][i] : 0.f) +
                       (m.diff_a ? sg[2][i] : 0.f);
      const float go = (m.own ? sg[3][i] : 0.f) + (m.same_o ? sg[4][i] : 0.f) +
                       (m.diff_o ? sg[5][i] : 0.f);
      const float c = kappa_a * sa * ga + kappa_o * so * go;
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

template <template <int> class Launch, typename... Args>
int dispatch_d(int d, Args... args) {
  switch (d) {
    case 16: Launch<16>::run(args...); break;
    case 32: Launch<32>::run(args...); break;
    case 64: Launch<64>::run(args...); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int D>
struct LaunchStats {
  static void run(const float* emb, const int* pix_lab, const int* own,
                  const int* pix_tag, const float* protos,
                  const int* proto_lab, const int* proto_tag,
                  const int* proto_valid, const int* num_valid, int n, int p,
                  float kappa_a, float kappa_o, int square, float* out,
                  cudaStream_t stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    joint_stats_kernel<D><<<blocks, THREADS, 0, stream>>>(
        emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
        proto_valid, num_valid, n, p, kappa_a, kappa_o, square, out);
  }
};

template <int D>
struct LaunchGradEmb {
  static void run(const float* emb, const int* pix_lab, const int* own,
                  const int* pix_tag, const float* protos,
                  const int* proto_lab, const int* proto_tag,
                  const int* proto_valid, const int* num_valid, int n, int p,
                  float kappa_a, float kappa_o, int square,
                  const float* grads, float* d_emb, cudaStream_t stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    joint_grad_emb_kernel<D><<<blocks, THREADS, 0, stream>>>(
        emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
        proto_valid, num_valid, n, p, kappa_a, kappa_o, square, grads,
        d_emb);
  }
};

template <int D>
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
      joint_grad_proto_kernel<D><<<grid, THREADS, 0, stream>>>(
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
  return dispatch_d<LaunchStats>(d, emb, pix_lab, own, pix_tag, protos,
                                 proto_lab, proto_tag, proto_valid,
                                 num_valid, n, p, kappa_a, kappa_o, square,
                                 out, (cudaStream_t)stream);
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
  return dispatch_d<LaunchGradEmb>(d, emb, pix_lab, own, pix_tag, protos,
                                   proto_lab, proto_tag, proto_valid,
                                   num_valid, n, p, kappa_a, kappa_o, square,
                                   grads, d_emb, (cudaStream_t)stream);
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
  return dispatch_d<LaunchGradProto>(
      d, emb, pix_lab, own, pix_tag, protos, proto_lab, proto_tag,
      proto_valid, num_valid, n, p, kappa_a, kappa_o, square, grads, chunk,
      partial, n_chunks, d_protos, (cudaStream_t)stream);
}

}  // extern "C"
