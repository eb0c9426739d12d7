// Shared pieces of the CUDA-core vocab kernels (the f32 cross entropy of
// csrc/ce_fwd.cu and csrc/ce_bwd.cu, and csrc/topk.cu): the tile shape,
// staging of rows into shared memory, and one 64 x 64 tile of logits
// h . W_v recomputed from the staged rows.
//
// Layout: h is (N, D) and the vocab table W is (V, D), both row-major in
// the operand type T (f32 or bf16), so every row is contiguous along D and
// a vocab tile is TV consecutive rows of W. Staged rows are f32 with a row
// stride of D + 1 (odd, since the wrappers require D % 8 == 0), so the
// threads of a warp that read one column of 16 different rows hit 16
// different banks. A block has 256 threads as a 16 x 16 grid (ty, tx); in a
// tile, thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
// (i, j < 4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ce {

constexpr int TN = 64;        // rows of h per tile
constexpr int TV = 64;        // vocab rows of W per tile
constexpr int kThreads = 256; // 16 x 16
constexpr int kMaxD = 256;    // D handled as tx + 16 t, t < 16
constexpr float NEG = -1e30f; // the TPU kernels' running-max start

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// rows [row0, row0 + count) of a row-major (total, d) T array -> f32 rows
// of stride d + 1 in shared memory; rows past `total` are zero. 16-byte
// loads (the wrappers require 16-byte aligned tensors and d * sizeof(T) a
// multiple of 16).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           int total, int row0, int count,
                                           int d, float* dst) {
  constexpr int kPer16 = 16 / (int)sizeof(T);
  const int chunks = d / kPer16;
  const int stride = d + 1;
  for (int e = threadIdx.x; e < count * chunks; e += blockDim.x) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * kPer16;
    float* out = dst + r * stride + c;
    if (row0 + r < total) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * d + c);
      const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int t = 0; t < kPer16; ++t) out[t] = to_float(x[t]);
    } else {
#pragma unroll
      for (int t = 0; t < kPer16; ++t) out[t] = 0.f;
    }
  }
}

// acc[i][j] = sum_d hs[ty + 16 i][d] * ws[tx + 16 j][d], in f32, d in order
__device__ __forceinline__ void tile_logits(const float* __restrict__ hs,
                                            const float* __restrict__ ws,
                                            int d, int ty, int tx,
                                            float acc[4][4]) {
  const int stride = d + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < d; ++k) {
    float a[4];
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = hs[(ty + 16 * i) * stride + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = ws[(tx + 16 * j) * stride + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

}  // namespace ce
