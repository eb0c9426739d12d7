// Shared pieces of the CUDA-core vocab kernels at any width D
// (csrc/ce_wide.cu): the tile shape, a column chunk of rows staged into
// shared memory as f32, and one 64 x 64 tile of logits h . W_v with D
// streamed through shared memory in chunks of KC columns.
//
// Layout: h is (N, D) and the vocab table W is (V, D), row-major, of one
// type T (float, or __nv_bfloat16 converted to f32 as it is staged: every
// product of two bf16 values is exact in f32). A chunk holds KC columns of
// TN (or TV) rows at a row stride of KC + 1 floats, so the threads of a
// warp that read one column of 16 different rows hit 16 different banks;
// columns past D and rows past the array's end are staged as 0, so any D
// takes the same code and a ragged last chunk adds exact zeros. A block has
// 256 threads as a 16 x 16 grid (ty, tx); in a tile, thread (ty, tx) owns
// rows ty + 16 i and columns tx + 16 j (i, j < 4), and its 16 sums run over
// d in order 0..D-1, as the tuned f32 kernels' (csrc/ce_tile.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wide {

constexpr int TN = 64;         // rows of h per tile
constexpr int TV = 64;         // vocab rows of W per tile
constexpr int KC = 32;         // columns of D per staged chunk
constexpr int kThreads = 256;  // 16 x 16
constexpr int kCStride = KC + 1;
constexpr float NEG = -1e30f;  // the TPU kernels' running-max start

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// columns [c0, c0 + KC) of rows [row0, row0 + count) of a row-major
// (total, d) array -> f32 at row stride kCStride; zero past `total` rows and
// past d columns
template <typename T>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ src,
                                            int total, int row0, int count,
                                            int d, int c0, float* dst) {
  for (int e = threadIdx.x; e < count * KC; e += blockDim.x) {
    const int r = e / KC;
    const int c = e - r * KC;
    const int row = row0 + r;
    const int col = c0 + c;
    dst[r * kCStride + c] =
        row < total && col < d ? to_f(src[(size_t)row * d + col]) : 0.f;
  }
}

// acc[i][j] = sum_d h[row0 + ty + 16 i][d] * w[col0 + tx + 16 j][d] in
// f32, d in order, D streamed in chunks through hs (TN x kCStride) and ws
// (TV x kCStride). Every thread of the block must call it (it holds
// barriers); it starts with one, so the caller's earlier reads of hs and ws
// are done before they are overwritten.
template <typename T>
__device__ __forceinline__ void tile_logits(const T* __restrict__ h,
                                            const T* __restrict__ w, int n,
                                            int v, int d, int row0, int col0,
                                            float* hs, float* ws, int ty,
                                            int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < d; c0 += KC) {
    __syncthreads();
    stage_chunk(h, n, row0, TN, d, c0, hs);
    stage_chunk(w, v, col0, TV, d, c0, ws);
    __syncthreads();
    const int kc = d - c0 < KC ? d - c0 : KC;
    for (int k = 0; k < kc; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[(ty + 16 * i) * kCStride + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[(tx + 16 * j) * kCStride + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// vocab tiles of TV rows per split, or -1 when the arguments are bad or a
// split would own no tile
inline int split_tiles(int n, int d, int v, int splits) {
  if (n <= 0 || v <= 0 || d <= 0 || splits <= 0) return -1;
  const int nvt = (v + TV - 1) / TV;
  const int tps = (nvt + splits - 1) / splits;
  return (splits - 1) * tps >= nvt ? -1 : tps;
}

// (TN, TV, blocks of `kernel` per SM) into out[3] for the wrappers' vocab
// splits; 0 on success, else a CUDA error
inline int tiling(const void* kernel, int* out) {
  out[0] = TN;
  out[1] = TV;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                            kThreads, 0);
}

}  // namespace wide
