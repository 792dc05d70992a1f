// Dilated 3x3 convolution, stride 1, padding d, NHWC bf16 in and out, for
// NVIDIA Hopper (sm_90a). Replaces K10, `_kernel` of
// pyscripts/misc/pallas_dilated_conv_probe.py:31 (via `pallas_conv`, :42):
// nine shifted [HW, C] x [C, O] tap products with a float32 accumulator,
// the output rounded once to bf16.
//
//   out[b, h, w, o] = sum_{i, j, c} x[b, h + (i - 1) d, w + (j - 1) d, c]
//                                   * wt[i, j, c, o]
//   (taps outside the image read zero; wt in HWIO, as the probe's weights)
//
// What bounds it on this card: operations. At the probe's res4 shape
// (B = 8, 64 x 64, C = O = 256, d = 2) the product is 38.7 GFLOP against
// 35 MB of inputs and outputs: ~0.04 ms at the bf16 tensor-core peak
// (989 TFLOP/s) against 0.01 ms at 3.35 TB/s. So the products run on the
// tensor cores in bf16 with float32 accumulators.
//
// Design: an implicit GEMM, M = B H W output pixels, N = O, K = 9 C,
// never materializing the [M, 9 C] patch matrix.
//   - A block computes a 128 x 128 output tile with 8 warps (2 x 4), each
//     warp 64 x 32 as 4 x 2 `nvcuda::wmma` 16 x 16 x 16 bf16 fragments
//     with float32 accumulators.
//   - The K loop walks the nine taps and, inside each, C in chunks of 32.
//     A thread gathers its rows of the A tile (one output pixel's shifted
//     input row, 16-byte vectors; zero outside the image, past C or past
//     M) and of the B tile (weight rows, zero past C or O) into registers
//     while the warps multiply the tile already in shared memory: two
//     shared-memory stages, one barrier a step.
//   - The epilogue passes each accumulator fragment through a per-warp
//     16 x 16 float32 scratch and writes bf16 rows of 8 channels.
// Left for later: wgmma and TMA, a deeper cp.async pipeline, and reusing
// one input tile across the taps that overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;  // a warp's tile
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int LDA = BK + 8;  // bf16 elements; the +8 staggers the banks
constexpr int LDB = BN + 8;
constexpr int A_ELEMS = BM * LDA, STAGE = BM * LDA + BK * LDB;
constexpr int A_VECS = BM * BK / 8 / THREADS;  // 16-byte vectors a thread
constexpr int B_VECS = BK * BN / 8 / THREADS;

struct Shape {
  int b, h, w, c, o, d;
};

__global__ void __launch_bounds__(THREADS) dilated_conv3x3_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
    __nv_bfloat16* __restrict__ out, Shape s) {
  __shared__ __align__(128) __nv_bfloat16 smem[2 * STAGE];
  __shared__ __align__(128) float scratch[THREADS / 32][16 * 16];

  const long long m_total = (long long)s.b * s.h * s.w;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;

  // The A rows this thread gathers (row = tid / 4 + 64 i, 8 channels at
  // (tid % 4) * 8): output pixel coordinates, fixed over the K loop.
  int a_img[A_VECS], a_h[A_VECS], a_w[A_VECS];
  bool a_live[A_VECS];
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const long long m = m0 + tid / 4 + i * (THREADS / 4);
    a_live[i] = m < m_total;
    const long long mm = a_live[i] ? m : 0;
    a_img[i] = (int)(mm / ((long long)s.h * s.w));
    const int rem = (int)(mm % ((long long)s.h * s.w));
    a_h[i] = rem / s.w;
    a_w[i] = rem % s.w;
  }
  const int a_seg = (tid % 4) * 8;

  const int c_steps = (s.c + BK - 1) / BK;
  const int k_steps = 9 * c_steps;
  uint4 ra[A_VECS], rb[B_VECS];

  auto gather = [&](int step) {
    const int tap = step / c_steps, c0 = (step % c_steps) * BK;
    const int dy = (tap / 3 - 1) * s.d, dx = (tap % 3 - 1) * s.d;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int hh = a_h[i] + dy, ww = a_w[i] + dx, c = c0 + a_seg;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (a_live[i] && hh >= 0 && hh < s.h && ww >= 0 && ww < s.w &&
          c < s.c) {
        const size_t off =
            (((size_t)a_img[i] * s.h + hh) * s.w + ww) * s.c + c;
        v = *reinterpret_cast<const uint4*>(x + off);
      }
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int idx = tid + i * THREADS;
      const int c = c0 + idx / (BN / 8), n = n0 + (idx % (BN / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (c < s.c && n < s.o) {
        v = *reinterpret_cast<const uint4*>(
            wt + ((size_t)tap * s.c + c) * s.o + n);
      }
      rb[i] = v;
    }
  };
  auto stage_in = [&](int buf) {
    __nv_bfloat16* as = smem + buf * STAGE;
    __nv_bfloat16* bs = as + A_ELEMS;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int row = tid / 4 + i * (THREADS / 4);
      *reinterpret_cast<uint4*>(as + row * LDA + a_seg) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int idx = tid + i * THREADS;
      *reinterpret_cast<uint4*>(bs + (idx / (BN / 8)) * LDB +
                                (idx % (BN / 8)) * 8) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  gather(0);
  stage_in(0);
  __syncthreads();
  for (int step = 0; step < k_steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < k_steps) gather(step + 1);  // loads in flight
    const __nv_bfloat16* as = smem + buf * STAGE;
    const __nv_bfloat16* bs = as + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], as + (warp_m * WM + i * 16) * LDA + kk,
                               LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * LDB + warp_n * WN + j * 16,
                               LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (step + 1 < k_steps) stage_in(buf ^ 1);
    __syncthreads();
  }

  float* cs = scratch[warp];
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + warp_m * WM + i * 16 + r;
      const int n = n0 + warp_n * WN + j * 16 + c8;
      if (m < m_total && n < s.o) {
        alignas(16) __nv_bfloat162 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = __floats2bfloat162_rn(cs[r * 16 + c8 + 2 * q],
                                       cs[r * 16 + c8 + 2 * q + 1]);
        *reinterpret_cast<uint4*>(out + (size_t)m * s.o + n) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// x [B, H, W, C], w [3, 3, C, O] (HWIO), out [B, H, W, O], all bf16,
// contiguous and 16-byte aligned; C and O multiples of 16, d >= 1.
int dilated_conv3x3_bf16(const void* x, const void* w, void* out, int b,
                         int h, int wd, int c, int o, int d, void* stream) {
  if (c % 16 != 0 || o % 16 != 0 || d < 1 || b < 0 || h < 0 || wd < 0)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)b * h * wd;
  if (m == 0 || o == 0) return 0;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (o + BN - 1) / BN);
  dilated_conv3x3_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      Shape{b, h, wd, c, o, d});
  return (int)cudaGetLastError();
}

}  // extern "C"
