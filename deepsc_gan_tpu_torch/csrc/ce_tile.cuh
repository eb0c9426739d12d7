// Shared pieces of the CUDA-core vocab kernels (the f32 cross entropy of
// csrc/ce_fwd.cu and csrc/ce_bwd.cu, and csrc/topk.cu): the tile shape,
// staging of rows into shared memory, and one 64 x 64 tile of logits
// h . W_v recomputed from the staged rows.
//
// Layout: h is (N, D) and the vocab table W is (V, D), both row-major f32,
// so every row is contiguous along D and a vocab tile is TV consecutive
// rows of W. Staged rows are f32 with a row
// stride of D + 1 (odd, since the wrappers require D % 8 == 0), so the
// threads of a warp that read one column of 16 different rows hit 16
// different banks. A block has 256 threads as a 16 x 16 grid (ty, tx); in a
// tile, thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
// (i, j < 4).

#pragma once

#include <cuda_runtime.h>

namespace ce {

constexpr int TN = 64;        // rows of h per tile
constexpr int TV = 64;        // vocab rows of W per tile
constexpr int kThreads = 256; // 16 x 16
constexpr int kMaxD = 256;    // D handled as tx + 16 t, t < 16
constexpr float NEG = -1e30f; // the TPU kernels' running-max start

// rows [row0, row0 + count) of a row-major (total, d) f32 array -> rows of
// stride d + 1 in shared memory; rows past `total` are zero. 16-byte loads
// (the wrappers require 16-byte aligned tensors and d a multiple of 4).
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int total, int row0, int count,
                                           int d, float* dst) {
  const int chunks = d / 4;
  const int stride = d + 1;
  for (int e = threadIdx.x; e < count * chunks; e += blockDim.x) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 4;
    float* out = dst + r * stride + c;
    const float4 x = row0 + r < total
        ? *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * d + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
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
