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
// (989 TFLOP/s) against 0.01 ms at 3.35 TB/s. Only `wgmma` reaches that
// peak, so the operands go to shared memory by TMA in the 128-byte
// swizzled forms `wgmma` reads.
//
// Design: an implicit GEMM, M = B H W output pixels, N = O, K = 9 C,
// never materializing the [M, 9 C] patch matrix.
//   - A block computes 128 output pixels, an 8-row x 16-column patch of
//     one image, times BN = 256 output channels. Grid:
//     B ceil(H / 8) ceil(W / 16) x ceil(O / 256).
//   - One K step is one tap x 64 input channels. Operand A is one 4-D TMA
//     box {64, 16, 8, 1} of x seen as [C, W, H, B] (innermost first) at
//     {c0, w0 + (j - 1) d, h0 + (i - 1) d, b}: coordinates that fall
//     outside the image, and channels past C, arrive as zeros, so the
//     zero fill is the padding and no thread checks a bound. The box lands
//     as 128 rows of 128 bytes, row m = pixel (h0 + m / 16, w0 + m % 16).
//     Operand B is read from the HWIO weights as they are, MN-major (O
//     contiguous): four 3-D boxes {64, 64, 1} of wt seen as [O, C, 9] at
//     {n0 + 64 q, c0, tap}, each 64 input-channel rows of 64 output
//     channels (zeros past C and O), which `wgmma` reads transposed
//     (imm-trans-b). The nine A boxes of a tile overlap and are read again
//     from L2 (the whole input fits in its 50 MB).
//   - A ring of STAGES = 4 stages of A (16 KB) + B (32 KB), each with a
//     full and an empty mbarrier. One thread of a producer warp of its
//     own issues the five loads of a step as soon as its stage is
//     released; the full barrier expects the whole boxes' bytes, zero
//     fill included.
//   - Two consumer warpgroups, each 64 pixels x 256 channels: four
//     wgmma.mma_async m64n256k16 (bf16 in, float32 accumulators) a step,
//     one group kept in flight (wait_group 1); a stage is released when
//     the group that read it has retired. The consumers never branch
//     while a group is in flight (their waits loop inside the asm and
//     their release is predicated), which keeps ptxas from serializing
//     the wgmma (warning C7518).
//   - The epilogue rounds once to bf16, stages the tile in shared memory
//     and stores 16-byte rows of 8 channels, masked to pixels inside the
//     image and channels below O.
// The tile geometry (box coordinates, tile origins, grid) is mirrored in
// Python by ops/dilated_conv.py (`tile_grid`, `tile_origin`,
// `box_coords`), which the CPU tests replay box by box.
// Tried on the card and slower than this design, so not kept: a cluster
// of two blocks along M multicasting the weight rows (16 KB less from L2 a
// step, but each pair waits on its slower block), and a persistent grid
// that stores the output straight from the registers (4-byte stores, 16
// bytes a row per warp instruction) while the producer loads the next
// tile. Left for later: a persistent grid with an epilogue staged in
// shared memory of its own (a TMA store), which leaves room for only three
// stages, and setmaxnreg for the producer warp (154 registers leave no
// pressure today).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_H = 8, TILE_W = 16;  // a block's output pixels
constexpr int BM = TILE_H * TILE_W;     // 128
constexpr int BN = 256;                 // a block's output channels
constexpr int BK = 64;                  // input channels of a step (128 B)
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;  // two warpgroups, 64 pixels each
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int W_BOX_BYTES = 64 * BK * 2;  // 64 output x 64 input channels
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// + 1024: the ring starts at the first 1024-byte boundary (128-byte swizzle)
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
constexpr int LDO = BN + 8;  // epilogue tile row, bf16; +8 staggers banks
static_assert(BM * LDO * 2 <= STAGES * STAGE_BYTES, "epilogue tile");

struct Shape {
  int b, h, w, c, o, d;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrive on the barrier where `pred` holds (predicated, not branched on:
// the consumers call it with a wgmma in flight).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 state;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed
// (the loop inside the asm, as the consumers wait with a wgmma in flight).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The same for the producer, but a wait of more than ~2^34 cycles
// (seconds) traps, so a barrier that never completes ends the launch with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, uint64_t map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, uint64_t map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of an operand in the 128-byte swizzled
// layout (type 1, B128): start address, leading and stride byte offsets,
// in 16-byte units.
//   K-major (A): rows of 128 bytes (64 K values), 8-row groups 1024 bytes
//     apart (stride); the leading offset is unused. A k16 step advances
//     the start address by 32 bytes inside the row.
//   MN-major (B): rows of 128 bytes (64 N values) per K value, 8-row
//     groups 1024 bytes apart (stride), 64-wide N chunks `lead` bytes
//     apart. A k16 step advances the start address by two groups (2 KB).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lead = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving accumulator accesses across wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] B[16 x 256] from shared memory, A K-major, B
// MN-major (imm-trans-b = 1).
#define ACC8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96),
        ACC8(104), ACC8(112), ACC8(120)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
#undef ACC8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1) dilated_conv3x3_kernel(
    const __grid_constant__ CUtensorMap x_map,
    const __grid_constant__ CUtensorMap w_map,
    __nv_bfloat16* __restrict__ out, Shape s) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES], empty_bar[STAGES];

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // stage st at st * STAGE_BYTES
  const int tid = threadIdx.x, wg = tid / 128;

  // the tile: image img, pixels [h0, h0 + 8) x [w0, w0 + 16), channels
  // [n0, n0 + BN)
  const int tiles_h = (s.h + TILE_H - 1) / TILE_H;
  const int tiles_w = (s.w + TILE_W - 1) / TILE_W;
  const int img = blockIdx.x / (tiles_h * tiles_w);
  const int rem = blockIdx.x % (tiles_h * tiles_w);
  const int h0 = rem / tiles_w * TILE_H, w0 = rem % tiles_w * TILE_W;
  const int n0 = blockIdx.y * BN;
  const int chunks = (s.c + BK - 1) / BK, k_steps = 9 * chunks;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(smem_addr(&full_bar[st]), 1);   // the producer's arrival
      mbar_init(smem_addr(&empty_bar[st]), 2);  // one per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[128];
  if (tid >= CONSUMERS) {
    // the producer warp: one thread keeps the ring full, the loads of K
    // step j (tap j / chunks, channel chunk j % chunks) into stage
    // j % STAGES once the consumers have released it
    if (tid == CONSUMERS) {
      const uint64_t xm = reinterpret_cast<uint64_t>(&x_map);
      const uint64_t wm = reinterpret_cast<uint64_t>(&w_map);
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(xm) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(wm) : "memory");
      for (int j = 0; j < k_steps; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES)
          mbar_wait_or_trap(smem_addr(&empty_bar[st]), (j / STAGES - 1) & 1);
        const int tap = j / chunks, c0 = (j - tap * chunks) * BK;
        const int dy = (tap / 3 - 1) * s.d, dx = (tap % 3 - 1) * s.d;
        const uint32_t a = ring + st * STAGE_BYTES;
        const uint32_t bar = smem_addr(&full_bar[st]);
        mbar_expect_tx(bar, STAGE_BYTES);  // the whole boxes, zeros included
        tma_load_4d(a, xm, bar, c0, w0 + dx, h0 + dy, img);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)  // 64 output channels a box
          tma_load_3d(a + A_BYTES + q * W_BOX_BYTES, wm, bar, n0 + 64 * q,
                      c0, tap);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int k = 0; k < k_steps; ++k) {
      const int st = k % STAGES;
      mbar_wait(smem_addr(&full_bar[st]), (k / STAGES) & 1);
      const uint32_t a = ring + st * STAGE_BYTES + wg * (64 * 128);
      const uint32_t b = ring + st * STAGE_BYTES + A_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16(acc, sw128_desc(a + 32 * kk),
                         sw128_desc(b + 2048 * kk, W_BOX_BYTES));
      wgmma_commit();
      wgmma_wait<1>();  // step k - 1's group has retired: free its stage
      fence_acc(acc);
      if (k > 0)
        mbar_arrive_if(smem_addr(&empty_bar[(k - 1) % STAGES]),
                       tid % 128 == 0);
    }
    wgmma_wait<0>();
    fence_acc(acc);
  }
  __syncthreads();  // every wgmma has read its last stage: reuse the ring

  // accumulator layout of m64nNk16: warp q of the warpgroup holds rows
  // 16 q + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1)
  __nv_bfloat16* tile =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (ring - raw));
  if (tid < CONSUMERS) {
    const int lane = tid % 32;
    const int r0 = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
    const int cq = (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(tile + r0 * LDO + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(tile + (r0 + 8) * LDO + 8 * j +
                                         cq) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  // tile row m is pixel (h0 + m / 16, w0 + m % 16), the box's row order
  for (int i = tid; i < BM * (BN / 8); i += THREADS) {
    const int m = i / (BN / 8), v = i % (BN / 8);
    const int hh = h0 + m / TILE_W, ww = w0 + m % TILE_W, n = n0 + 8 * v;
    if (hh < s.h && ww < s.w && n < s.o) {
      const size_t off = (((size_t)img * s.h + hh) * s.w + ww) * s.o + n;
      *reinterpret_cast<uint4*>(out + off) =
          *reinterpret_cast<const uint4*>(tile + m * LDO + 8 * v);
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver at run time so that the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
    return cudaErrorSymbolNotFound;
  *fn = reinterpret_cast<EncodeTiled>(ptr);
  return cudaSuccess;
}

// A bf16 tensor map with 128-byte swizzled boxes and zero fill outside.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

extern "C" {

// x [B, H, W, C], w [3, 3, C, O] (HWIO), out [B, H, W, O], all bf16,
// contiguous and 16-byte aligned; C and O multiples of 16, d >= 1. Returns
// 0, a cudaError_t, or minus the CUresult of a failed tensor-map encode.
int dilated_conv3x3_bf16(const void* x, const void* w, void* out, int b,
                         int h, int wd, int c, int o, int d, void* stream) {
  if (c % 16 != 0 || o % 16 != 0 || d < 1 || b < 0 || h < 0 || wd < 0)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)b * h * wd;
  if (m == 0 || o == 0) return 0;
  if (c == 0)  // no input channel: zeros (a tensor map has no empty dim)
    return (int)cudaMemsetAsync(out, 0, (size_t)m * o * 2,
                                (cudaStream_t)stream);

  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    const cudaError_t err = encoder(&fn);
    if (err != cudaSuccess) return (int)err;
  }
  const cuuint64_t e = 2;  // bytes of a bf16
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[4] = {(cuuint64_t)c, (cuuint64_t)wd, (cuuint64_t)h,
                                (cuuint64_t)b};
  const cuuint64_t x_strides[3] = {c * e, (cuuint64_t)wd * c * e,
                                   (cuuint64_t)h * wd * c * e};
  const cuuint32_t x_box[4] = {BK, TILE_W, TILE_H, 1};
  CUresult r = encode(fn, &x_map, x, 4, x_dims, x_strides, x_box);
  if (r != CUDA_SUCCESS) return -(int)r;
  const cuuint64_t w_dims[3] = {(cuuint64_t)o, (cuuint64_t)c, 9};
  const cuuint64_t w_strides[2] = {o * e, (cuuint64_t)c * o * e};
  const cuuint32_t w_box[3] = {64, BK, 1};
  r = encode(fn, &w_map, w, 3, w_dims, w_strides, w_box);
  if (r != CUDA_SUCCESS) return -(int)r;

  cudaError_t err = cudaFuncSetAttribute(
      dilated_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles = b * ((h + TILE_H - 1) / TILE_H) *
                    ((wd + TILE_W - 1) / TILE_W);
  const dim3 grid((unsigned)tiles, (unsigned)((o + BN - 1) / BN));
  dilated_conv3x3_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x_map, w_map, static_cast<__nv_bfloat16*>(out), Shape{b, h, wd, c, o, d});
  return (int)cudaGetLastError();
}

}  // extern "C"
