// KNN retrieval: the labels of each query's top k prototypes of a bank by
// float32 dot product, in one pass over the bank, for NVIDIA Hopper
// (sm_90a). It replaces no TPU kernel: spml_tpu/ops/knn.py::top_k_ranking
// leaves the [N, P] product and jax.lax.top_k to XLA. The port's plain form
// (ops/knn.py, the CPU's path) writes the [N, P] score matrix and sorts
// every row in full; at KNN inference against a VOC-sized bank (N = 144
// segments, P = 1,523,808 prototypes, D = 64) that is an 877 MB matrix, a
// masked copy and a radix sort of 1.5M-long rows to keep 20 of each.
//
// Order: score descending, then index ascending (jax.lax.top_k's tie rule,
// which the plain form's stable sort keeps); a NaN score above every
// number, where both put it. The pair (score, index) is a strict total
// order, so the result depends on no block's timing. A prototype outside
// the mask scores exactly -1e30: below every valid one, among the masked
// ones by index. No float atomics.
//
// What bounds it on this card: operations. N P D multiply-adds (28.1
// GFLOP at the VOC shape: 0.42 ms at 67 TFLOP/s FFMA, 0.17 ms as split
// TF32 on the tensor cores) against one read of the bank (390 MB: 0.12 ms
// at 3.35 TB/s). The selection costs a compare a score once the running
// k-th is set, and rarely more.
//
// Design, two launches:
//   knn_topk_partial: grid (query tiles) x (bank chunks), 256 threads. A
//     block keeps its QT = 48 queries in shared memory (D-major) and
//     streams its chunk of the bank through shared memory in tiles of 256
//     rows, 8 dimensions a stage, double-buffered, transposed on the way
//     in. Each thread computes a TQ x 8 = 6 x 8 register tile of float32
//     dot products with FFMA (every sum in float32, d ascending). After
//     each tile a score enters its query's candidate buffer only if it
//     beats the k-th of the query's sorted list as of the list's last
//     merge. When a buffer overflows, and at the chunk's end, the warps
//     merge every buffer into its list by ranks, and the overflow is filed
//     again against the new k-th. So after the first tiles a score costs
//     one compare. Lists and buffers hold each score as an int key of the
//     same order (order_key), so a NaN costs the merges nothing. The
//     chunk's top k of each query goes to scratch [chunks, N, k] (keys,
//     then indices).
//   knn_topk_merge: one block a query takes the best k of its chunks x k
//     candidates, one block-wide arg-best a rank under the same order,
//     and writes the labels of the winners.
// The wrapper (ops/knn.py) picks the chunk count and the rows a chunk (a
// multiple of 256) so that the grid fills about one wave of the card
// (each block pays its own warm-up, the first tiles' merges). On an H100
// at the VOC shape both launches take ~1.15 ms; the dot products alone
// (the selection taken out) 0.88 ms, ~48% of the FFMA rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 6;       // queries of a thread's register tile
constexpr int QT = 8 * TQ;  // queries of a block
constexpr int BT = 256;     // bank rows a tile
constexpr int KC = 8;       // dimensions a stage
constexpr int MAXK = 32;    // the largest k
constexpr int CAP = 64;     // a query's candidate buffer
constexpr int MAXD = 128;   // the largest D
constexpr int MERGE_THREADS = 128;
constexpr int MERGE_PER_THREAD = 32;  // chunks x k <= 4096
constexpr float MASKED = -1e30f;
constexpr int SENTINEL_INDEX = 0x7fffffff - MAXK;  // + rank: below all

constexpr int NAN_KEY = 0x7fffffff;
constexpr int NO_KEY = -0x7fffffff - 1;  // below every score's key

// An int that orders as the score under the kernel's order: NaN, of any
// payload, above every number; the numbers in their float order, -0 and
// +0 one key. The lists, the merges and the scratch hold these keys.
__device__ __forceinline__ int order_key(float s) {
  const int b = __float_as_int(s);
  return isnan(s) ? NAN_KEY : b >= 0 ? b : -(b & 0x7fffffff);
}

// The score a key stands for, as the filing threshold: NaN's key gives
// +inf (no number beats it; a NaN score and an infinite one pass the
// filter and are ranked in the merge).
__device__ __forceinline__ float threshold(int key) {
  return key == NAN_KEY ? INFINITY
                        : __int_as_float(key >= 0 ? key
                                                  : int(0x80000000u | -key));
}

// (k1, i1) ranks before (k2, i2): the key descending, then the index
// ascending
__device__ __forceinline__ bool before(int k1, int i1, int k2, int i2) {
  return k1 > k2 || (k1 == k2 && i1 < i2);
}

// A score that may rank before the threshold pair (ts, ti): every one that
// does (the filter is exact below a NaN k-th: !(s <= ts) holds for s > ts
// and for a NaN s). Candidates are ranked exactly in the merges.
__device__ __forceinline__ bool may_beat(float s, int i, float ts, int ti) {
  return !(s <= ts) || (s == ts && i < ti);
}

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)d * QT + 2 * KC * BT)  // Qs, Bs
         + 2 * sizeof(int) * QT * (MAXK + CAP)           // lists
         + sizeof(int) * QT;                             // counts
}

// Merges query q's candidate buffer (c <= CAP, two a lane) into its sorted
// list (k <= 32, one a lane), one warp: a candidate's place is the number
// of list entries that beat it (a binary search) plus the number of
// candidates that do (a round of shuffles); a list entry moves down by
// the candidates whose list rank does not pass it.
__device__ __forceinline__ void merge_buffer(int* ls_q, int* li_q,
                                             const int* cs_q,
                                             const int* ci_q, int c, int k,
                                             int lane) {
  const int ls = lane < k ? ls_q[lane] : 0;
  const int li = lane < k ? li_q[lane] : 0;
  int xs[2], xi[2], rank[2] = {0, 0}, lr[2] = {k, k};
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    live[h] = lane + 32 * h < c;
    xs[h] = live[h] ? cs_q[lane + 32 * h] : NO_KEY;
    xi[h] = live[h] ? ci_q[lane + 32 * h] : 0x7fffffff;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && c <= 32) break;
    for (int src = 0; src < 32; ++src) {
      const int s = __shfl_sync(0xffffffffu, xs[h], src);
      const int i = __shfl_sync(0xffffffffu, xi[h], src);
      rank[0] += before(s, i, xs[0], xi[0]);
      rank[1] += before(s, i, xs[1], xi[1]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before(ls_q[mid], li_q[mid], xs[h], xi[h]))
        lo = mid + 1;
      else
        hi = mid;
    }
    lr[h] = lo;
  }
  int shift = 0;
  for (int l = 0; l < k; ++l) {
    const unsigned b0 = __ballot_sync(0xffffffffu, live[0] && lr[0] <= l);
    const unsigned b1 = __ballot_sync(0xffffffffu, live[1] && lr[1] <= l);
    const int below = __popc(b0) + __popc(b1);
    if (lane == l) shift = below;
  }
  __syncwarp();
  if (lane < k && lane + shift < k) {
    ls_q[lane + shift] = ls;
    li_q[lane + shift] = li;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int at = lr[h] + rank[h];
    if (live[h] && at < k) {
      ls_q[at] = xs[h];
      li_q[at] = xi[h];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 2)
knn_topk_partial_kernel(const float* __restrict__ emb,
                        const float* __restrict__ bank,
                        const unsigned char* __restrict__ mask, int n, int p,
                        int d, int k, int rows_per_chunk,
                        int* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);     // [d][QT]
  float* bs = qs + (size_t)d * QT;                    // [2][KC][BT]
  int* lst_s = reinterpret_cast<int*>(bs + 2 * KC * BT);  // [QT][MAXK] keys
  int* cand_s = lst_s + QT * MAXK;                        // [QT][CAP] keys
  int* lst_i = cand_s + QT * CAP;
  int* cand_i = lst_i + QT * MAXK;
  int* cnt = cand_i + QT * CAP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q_first = blockIdx.x * QT;
  const int chunk = blockIdx.y;
  const int row_first = chunk * rows_per_chunk;
  const int row_end = min(row_first + rows_per_chunk, p);
  const int tiles = (row_end - row_first + BT - 1) / BT;
  const int stages = d / KC;

  // the block's queries, D-major; rows past N are zeros
  for (int e = tid; e < QT * (d / 4); e += THREADS) {
    const int q = e / (d / 4), d4 = e % (d / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q_first + q < n)
      v = *reinterpret_cast<const float4*>(emb + (size_t)(q_first + q) * d +
                                           4 * d4);
    qs[(4 * d4 + 0) * QT + q] = v.x;
    qs[(4 * d4 + 1) * QT + q] = v.y;
    qs[(4 * d4 + 2) * QT + q] = v.z;
    qs[(4 * d4 + 3) * QT + q] = v.w;
  }
  for (int e = tid; e < QT * MAXK; e += THREADS) {
    lst_s[e] = order_key(-INFINITY);
    lst_i[e] = SENTINEL_INDEX + e % MAXK;
  }
  for (int e = tid; e < QT; e += THREADS) cnt[e] = 0;

  // thread tile: queries q0 .. q0 + TQ - 1, bank columns col(j), j < 8
  const int wq = warp >> 2, wb = warp & 3, lq = lane >> 3, lb = lane & 7;
  const int q0 = wq * 4 * TQ + lq * TQ;
  const int col0 = wb * 64 + lb * 4;
  bool q_live[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) q_live[i] = q_first + q0 + i < n;

  // stage loader: row tid of the tile, KC dimensions, through registers
  // (stored transposed: [KC][BT])
  float4 st[KC / 4];
  auto fetch = [&](int tile, int kc) {
    const int row = row_first + tile * BT + tid;
    if (row < row_end) {
      const float4* src = reinterpret_cast<const float4*>(
          bank + (size_t)row * d + kc * KC);
#pragma unroll
      for (int v = 0; v < KC / 4; ++v) st[v] = src[v];
    } else {
#pragma unroll
      for (int v = 0; v < KC / 4; ++v) st[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&](int buf) {
    float* dst = bs + buf * KC * BT + tid;
#pragma unroll
    for (int v = 0; v < KC / 4; ++v) {
      dst[(4 * v + 0) * BT] = st[v].x; dst[(4 * v + 1) * BT] = st[v].y;
      dst[(4 * v + 2) * BT] = st[v].z; dst[(4 * v + 3) * BT] = st[v].w;
    }
  };

  fetch(0, 0);
  stash(0);
  __syncthreads();

  auto merge_all = [&]() {
    for (int q = warp; q < QT; q += THREADS / 32) {
      const int c = min(cnt[q], CAP);
      if (c == 0) continue;
      merge_buffer(lst_s + q * MAXK, lst_i + q * MAXK, cand_s + q * CAP,
                   cand_i + q * CAP, c, k, lane);
      if (lane == 0) cnt[q] = 0;
    }
  };

  int buf = 0;
  float acc[TQ][8];
  for (int tile = 0; tile < tiles; ++tile) {
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int kc = 0; kc < stages; ++kc) {
      const bool last_kc = kc + 1 == stages;
      const bool more = !last_kc || tile + 1 < tiles;
      if (more) fetch(last_kc ? tile + 1 : tile, last_kc ? 0 : kc + 1);
      const float* bsb = bs + buf * KC * BT + col0;
      const float* qsk = qs + (size_t)kc * KC * QT + q0;
#pragma unroll
      for (int dd = 0; dd < KC; ++dd) {
        float a[TQ];
#pragma unroll
        for (int i = 0; i < TQ; i += 2) {
          const float2 v = *reinterpret_cast<const float2*>(qsk + dd * QT + i);
          a[i] = v.x;
          a[i + 1] = v.y;
        }
        const float4 b0 = *reinterpret_cast<const float4*>(bsb + dd * BT);
        const float4 b1 = *reinterpret_cast<const float4*>(bsb + dd * BT + 32);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) stash(buf ^ 1);
      buf ^= 1;
      __syncthreads();
    }
    // the tile's scores: masked ones at -1e30, columns past the chunk out
    const int base = row_first + tile * BT + col0;
    unsigned live_cols = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = base + (j & 3) + (j >> 2) * 32;
      if (col < row_end) {
        live_cols |= 1u << j;
        if (mask != nullptr && !mask[col]) {
#pragma unroll
          for (int i = 0; i < TQ; ++i) acc[i][j] = MASKED;
        }
      }
    }
    // filed against each list's k-th as of its last merge; a buffer that
    // overflows makes every warp merge its queries' buffers, then the
    // overflow is filed again
    uint64_t pending = 0;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      if (!q_live[i]) continue;
      const int q = q0 + i;
      const float ts = threshold(lst_s[q * MAXK + k - 1]);
      const int ti = lst_i[q * MAXK + k - 1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = base + (j & 3) + (j >> 2) * 32;
        if (((live_cols >> j) & 1u) && may_beat(acc[i][j], col, ts, ti)) {
          const int slot = atomicAdd(&cnt[q], 1);
          if (slot < CAP) {
            cand_s[q * CAP + slot] = order_key(acc[i][j]);
            cand_i[q * CAP + slot] = col;
          } else {
            pending |= 1ull << (i * 8 + j);
          }
        }
      }
    }
    while (__syncthreads_or(pending != 0)) {
      merge_all();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int q = q0 + i;
        if (!((pending >> (i * 8)) & 0xffull)) continue;
        const float ts = threshold(lst_s[q * MAXK + k - 1]);
        const int ti = lst_i[q * MAXK + k - 1];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint64_t bit = 1ull << (i * 8 + j);
          if (!(pending & bit)) continue;
          const int col = base + (j & 3) + (j >> 2) * 32;
          if (!may_beat(acc[i][j], col, ts, ti)) {
            pending &= ~bit;
            continue;
          }
          const int slot = atomicAdd(&cnt[q], 1);
          if (slot < CAP) {
            cand_s[q * CAP + slot] = order_key(acc[i][j]);
            cand_i[q * CAP + slot] = col;
            pending &= ~bit;
          }
        }
      }
    }
  }
  __syncthreads();
  merge_all();
  __syncthreads();

  for (int q = warp; q < QT; q += THREADS / 32) {
    if (q_first + q >= n || lane >= k) continue;
    const size_t at = ((size_t)chunk * n + q_first + q) * k + lane;
    part_s[at] = lst_s[q * MAXK + lane];
    part_i[at] = lst_i[q * MAXK + lane];
  }
}

template <typename L>
__global__ void __launch_bounds__(MERGE_THREADS)
knn_topk_merge_kernel(const int* __restrict__ part_s,
                      const int* __restrict__ part_i,
                      const L* __restrict__ labels, int n, int p, int k,
                      int chunks, L* __restrict__ out) {
  __shared__ int best_s[2][MERGE_THREADS / 32];
  __shared__ int best_i[2][MERGE_THREADS / 32];
  const int q = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m = chunks * k;
  int s[MERGE_PER_THREAD], idx[MERGE_PER_THREAD];
#pragma unroll
  for (int u = 0; u < MERGE_PER_THREAD; ++u) {
    const int e = tid + u * MERGE_THREADS;
    if (e < m) {
      const int c = e / k, r = e % k;
      const size_t at = ((size_t)c * n + q) * k + r;
      s[u] = part_s[at];
      idx[u] = part_i[at];
    } else {
      s[u] = NO_KEY;
      idx[u] = 0x7fffffff;
    }
  }
  int last_s = NAN_KEY, last_i = -1;  // before every pair
  for (int r = 0; r < k; ++r) {
    int bs = NO_KEY, bi = 0x7fffffff;
#pragma unroll
    for (int u = 0; u < MERGE_PER_THREAD; ++u) {
      if (before(last_s, last_i, s[u], idx[u]) &&
          before(s[u], idx[u], bs, bi)) {
        bs = s[u];
        bi = idx[u];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (before(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      best_s[r & 1][warp] = bs;
      best_i[r & 1][warp] = bi;
    }
    __syncthreads();
    bs = best_s[r & 1][0];
    bi = best_i[r & 1][0];
#pragma unroll
    for (int w = 1; w < MERGE_THREADS / 32; ++w) {
      if (before(best_s[r & 1][w], best_i[r & 1][w], bs, bi)) {
        bs = best_s[r & 1][w];
        bi = best_i[r & 1][w];
      }
    }
    last_s = bs;
    last_i = bi;
    // every chunk files min(k, its rows) real rows, so bi < p; a label of
    // no class if not
    if (tid == 0) out[(size_t)q * k + r] = bi < p ? labels[bi] : L(-1);
  }
}

}  // namespace

extern "C" {

// emb [n, d] and bank [p, d] float32, mask [p] bool or null; scratch holds
// chunks x n x k int32 order keys, then as many int32 indices. Rows of chunk c:
// [c rows_per_chunk, min((c + 1) rows_per_chunk, p)), none empty.
int knn_topk_partial(const float* emb, const float* bank,
                     const unsigned char* mask, int n, int p, int d, int k,
                     int chunks, int rows_per_chunk, void* scratch,
                     void* stream) {
  if (n <= 0 || p <= 0 || k < 1 || k > MAXK || k > p || d % KC != 0 ||
      d <= 0 || d > MAXD || rows_per_chunk % BT != 0 || chunks < 1 ||
      (long long)(chunks - 1) * rows_per_chunk >= p ||
      (long long)chunks * rows_per_chunk < p ||
      chunks * k > MERGE_THREADS * MERGE_PER_THREAD ||
      p > SENTINEL_INDEX)
    return (int)cudaErrorInvalidValue;
  int* part_s = static_cast<int*>(scratch);
  int* part_i = part_s + (size_t)chunks * n * k;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      knn_topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + QT - 1) / QT, chunks);
  knn_topk_partial_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      emb, bank, mask, n, p, d, k, rows_per_chunk, part_s, part_i);
  return (int)cudaGetLastError();
}

// scratch as knn_topk_partial left it; labels [p] of label_bytes (4: int32,
// 8: int64); out [n, k] of the same type.
int knn_topk_merge(const void* scratch, const void* labels, int label_bytes,
                   int n, int p, int k, int chunks, void* out, void* stream) {
  if (n <= 0 || p <= 0 || k < 1 || k > MAXK || chunks < 1 ||
      chunks * k > MERGE_THREADS * MERGE_PER_THREAD)
    return (int)cudaErrorInvalidValue;
  const int* part_s = static_cast<const int*>(scratch);
  const int* part_i = part_s + (size_t)chunks * n * k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (label_bytes == 8)
    knn_topk_merge_kernel<long long><<<n, MERGE_THREADS, 0, s>>>(
        part_s, part_i, static_cast<const long long*>(labels), n, p, k,
        chunks, static_cast<long long*>(out));
  else if (label_bytes == 4)
    knn_topk_merge_kernel<int><<<n, MERGE_THREADS, 0, s>>>(
        part_s, part_i, static_cast<const int*>(labels), n, p, k, chunks,
        static_cast<int*>(out));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
