// Fused beam-candidate scorer for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_topk_kernel` of deepsc_gan_tpu/ops/pallas/topk.py
// (reached through `topk_logits`, once per beam-search decode step). For each
// row n of h (N, D), over the vocab table W (V, D) and bias b (V):
//     logits_v = h_n . W_v + b_v           (f32 products and sums of operands
//                                           in h's type, f32 or bf16)
//     vals, idx = the k largest logits, descending, ties to the lowest v
//     lse = m + log(sum_v exp(logits_v - m)),  m = max_v logits_v
// The (N, V) logits never reach device memory.
//
// What bounds it: at the CLI's beam (N = 64 x 4 = 256, D = 128, V = 22,234,
// bf16) the 5.7 MB stream of W (1.7 us at 3.35 TB/s), just above the 1.46
// GFLOP of the products at the bf16 tensor-core rate (1.5 us); at the beam
// sweep (N = 19 x 256 = 4,864) the 27.7 GFLOP (28 us). This first version
// multiplies on the f32 CUDA cores (67 TFLOP/s), as the CE kernels do, so it
// cannot come within 15x of either bound; tensor cores are later work.
//
// Design: the TPU kernel walks the vocab tiles in order on one core, keeping
// a running top-k and an online max and sum. Here blocks run in parallel, so
// the vocab axis is cut into `splits` contiguous ranges (as the CE kernels,
// enough blocks to fill the 132 SMs at N = 256). Block (row tile, split)
// stages its 64 rows of h once and walks its range of 64-row tiles of W
// through shared memory (csrc/ce_tile.cuh). Thread (ty, tx) owns rows
// ty + 16 i and, in each tile, columns tx + 16 j; for each of its 4 rows it
// keeps a running (max, sum of exponentials) and a sorted list of its best 8
// candidates, ordered by (value descending, index ascending). The 16 threads
// of a row (16 consecutive lanes of one warp) merge their lists and sums by
// shuffles; one list and one (max, sum) per (split, row) go to a workspace.
// A second kernel, a warp per row, merges the splits' lists and sums and
// writes the first k of the list and lse. Because the order is total and
// every index is seen by one thread only, the merged list is the same
// whatever the merge order: ties go to the lowest index exactly as the TPU
// kernel's masked argmax does. The sums are merged in a fixed tree, so the
// result is deterministic. No atomics.

#include <math_constants.h>

#include "ce_tile.cuh"

namespace {

using ce::kThreads;
using ce::NEG;
using ce::TN;
using ce::TV;

constexpr int kMaxK = 8;     // candidates kept per row (k <= 8)
constexpr int kBig = 1 << 30;

// a before b in the order of the result: value descending, index ascending
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// insert (v, i) into the sorted list (lv, li), dropping its last entry: one
// compare-and-swap pass with every index known at compile time, so the list
// stays in registers
__device__ __forceinline__ void insert(float (&lv)[kMaxK], int (&li)[kMaxK],
                                       float v, int i) {
  if (!before(v, i, lv[kMaxK - 1], li[kMaxK - 1])) return;
#pragma unroll
  for (int t = 0; t < kMaxK; ++t) {
    if (before(v, i, lv[t], li[t])) {
      const float tv = lv[t];
      const int ti = li[t];
      lv[t] = v;
      li[t] = i;
      v = tv;
      i = ti;
    }
  }
}

// (m, s) <- the merge of two partial (max, sum of exp(x - max))
__device__ __forceinline__ void merge_ms(float& m, float& s, float m2,
                                         float s2) {
  const float mm = fmaxf(m, m2);
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

// merge the lists and sums of the lanes `lane ^ o` for o < width (a
// butterfly over `width` consecutive lanes of a warp)
__device__ __forceinline__ void merge_lanes(float (&lv)[kMaxK],
                                            int (&li)[kMaxK], float& m,
                                            float& s, int width) {
  for (int o = width / 2; o > 0; o /= 2) {
    float ov[kMaxK];
    int oi[kMaxK];
#pragma unroll
    for (int t = 0; t < kMaxK; ++t) {
      ov[t] = __shfl_xor_sync(0xffffffffu, lv[t], o);
      oi[t] = __shfl_xor_sync(0xffffffffu, li[t], o);
    }
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
    for (int t = 0; t < kMaxK; ++t) insert(lv, li, ov[t], oi[t]);
    merge_ms(m, s, om, os);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ part_v,
                    int* __restrict__ part_i, float* __restrict__ part_ms,
                    int n, int d, int v, int tiles_per_split) {
  extern __shared__ float smem[];
  const int stride = d + 1;
  float* hs = smem;              // TN x stride
  float* ws = hs + TN * stride;  // TV x stride

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * TN;
  const int split = blockIdx.y;
  const int nvt = (v + TV - 1) / TV;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, nvt);

  ce::stage_rows(h, n, row0, TN, d, hs);
  float m[4], s[4];
  float lv[4][kMaxK];
  int li[4][kMaxK];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    s[i] = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxK; ++t) {
      lv[i][t] = -CUDART_INF_F;
      li[i][t] = kBig;
    }
  }

  for (int t = t0; t < t1; ++t) {
    const int col0 = t * TV;
    __syncthreads();  // the previous tile's reads of ws are done
    ce::stage_rows(w, v, col0, TV, d, ws);
    __syncthreads();
    float acc[4][4];
    ce::tile_logits(hs, ws, d, ty, tx, acc);
    if (col0 + tx >= v) continue;  // this thread owns no column of the tile
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      bias[j] = c < v ? b[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float cm = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c < v) {
          acc[i][j] += bias[j];
          cm = fmaxf(cm, acc[i][j]);
          insert(lv[i], li[i], acc[i][j], c);
        }
      }
      const float mn = fmaxf(m[i], cm);
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col0 + tx + 16 * j < v) se += expf(acc[i][j] - mn);
      s[i] = s[i] * expf(m[i] - mn) + se;
      m[i] = mn;
    }
  }

  // the 16 threads of row group ty are lanes 16 (ty & 1) .. + 15 of a warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    merge_lanes(lv[i], li[i], m[i], s[i], 16);
    const int row = row0 + ty + 16 * i;
    if (tx == 0 && row < n) {
      const size_t o = (size_t)split * n + row;
#pragma unroll
      for (int t = 0; t < kMaxK; ++t) {
        part_v[o * kMaxK + t] = lv[i][t];
        part_i[o * kMaxK + t] = li[i][t];
      }
      part_ms[o * 2] = m[i];
      part_ms[o * 2 + 1] = s[i];
    }
  }
}

// a warp per row: lane l merges splits l, l + 32, ... in order, then the
// lanes are merged by a butterfly; lane 0 writes the first k and lse
__global__ void topk_combine_kernel(const float* __restrict__ part_v,
                                    const int* __restrict__ part_i,
                                    const float* __restrict__ part_ms,
                                    float* __restrict__ vals,
                                    int* __restrict__ idx,
                                    float* __restrict__ lse, int n, int k,
                                    int splits) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps leave together
  float lv[kMaxK];
  int li[kMaxK];
#pragma unroll
  for (int t = 0; t < kMaxK; ++t) {
    lv[t] = -CUDART_INF_F;
    li[t] = kBig;
  }
  float m = NEG, s = 0.f;
  for (int sp = lane; sp < splits; sp += 32) {
    const size_t o = (size_t)sp * n + row;
#pragma unroll
    for (int t = 0; t < kMaxK; ++t)
      insert(lv, li, part_v[o * kMaxK + t], part_i[o * kMaxK + t]);
    merge_ms(m, s, part_ms[o * 2], part_ms[o * 2 + 1]);
  }
  merge_lanes(lv, li, m, s, 32);
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kMaxK; ++t) {
      if (t < k) {
        vals[(size_t)row * k + t] = lv[t];
        idx[(size_t)row * k + t] = li[t];
      }
    }
    lse[row] = m + logf(s);
  }
}

size_t smem_bytes(int d) { return sizeof(float) * (size_t)(TN + TV) * (d + 1); }

template <typename T>
int launch(const void* h, const void* w, const void* b, void* vals, void* idx,
           void* lse, void* part_v, void* part_i, void* part_ms, int n, int d,
           int v, int k, int splits, void* stream) {
  if (n <= 0 || v <= 0 || d <= 0 || d > ce::kMaxD ||
      d % (16 / (int)sizeof(T)) || splits <= 0 || k < 1 || k > kMaxK ||
      k > v)
    return (int)cudaErrorInvalidValue;
  const int nvt = (v + TV - 1) / TV;
  const int tps = (nvt + splits - 1) / splits;
  if ((splits - 1) * tps >= nvt) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + TN - 1) / TN, splits);
  cudaStream_t st = (cudaStream_t)stream;
  topk_partial_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)h, (const T*)w, (const float*)b, (float*)part_v,
      (int*)part_i, (float*)part_ms, n, d, v, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int kRowsPerBlock = 8;  // 8 warps
  topk_combine_kernel<<<(n + kRowsPerBlock - 1) / kRowsPerBlock,
                        32 * kRowsPerBlock, 0, st>>>(
      (const float*)part_v, (const int*)part_i, (const float*)part_ms,
      (float*)vals, (int*)idx, (float*)lse, n, k, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the partial kernel needs.
size_t deepsc_topk_smem_bytes(int d) { return smem_bytes(d); }

// h: contiguous f32 (N, D); w: contiguous f32 (V, D); b: f32 (V);
// vals: f32 (N, k); idx: int32 (N, k); lse: f32 (N); part_v: f32 workspace
// (splits, N, 8); part_i: int32 (splits, N, 8); part_ms: f32 (splits, N, 2).
// 1 <= k <= min(8, V); every split must own at least one vocab tile of 64
// rows. Returns cudaGetLastError() after the launches (0 = success).
int deepsc_topk_f32(const void* h, const void* w, const void* b, void* vals,
                    void* idx, void* lse, void* part_v, void* part_i,
                    void* part_ms, int n, int d, int v, int k, int splits,
                    void* stream) {
  return launch<float>(h, w, b, vals, idx, lse, part_v, part_i, part_ms, n,
                       d, v, k, splits, stream);
}

// As above with h and w in bf16.
int deepsc_topk_bf16(const void* h, const void* w, const void* b, void* vals,
                     void* idx, void* lse, void* part_v, void* part_i,
                     void* part_ms, int n, int d, int v, int k, int splits,
                     void* stream) {
  return launch<__nv_bfloat16>(h, w, b, vals, idx, lse, part_v, part_i,
                               part_ms, n, d, v, k, splits, stream);
}

}  // extern "C"
