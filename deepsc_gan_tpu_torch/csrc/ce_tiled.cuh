// The 128 x 128 CUDA-core tile of the f32 vocab kernels (csrc/ce_fwd_tiled.cu,
// K3, csrc/ce_bwd_tiled.cu, K4, and the f32 K6 of csrc/topk.cu): a tile of
// 128 x 128 products summed over a depth streamed through shared memory in
// chunks of kBK, 256 threads each owning 8 x 8 of them, every sum in order
// of depth by fmaf (exact f32 products; no TF32). Operands are f32, or bf16
// converted to f32 as they are loaded (every product of two bf16 values is
// exact in f32).
//
// Layout: a chunk is staged as [depth][tile row] in shared memory (row
// stride kStride), loaded from device memory into registers while the
// block multiplies the chunk before it (two buffers), by one of two
// loaders: `DepthAlongRows` where the depth runs along the source's rows
// (h and W for the logits, P for dh), `DepthAlongColumns` where it runs
// down its columns (W for dh, P and h for dW). Values past the source's
// rows and columns load as 0, so a ragged edge adds exact zeros. Thread t
// = 16 ty + tx owns tile rows at(ty, i) and columns at(tx, j), i, j < 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace tiled {

constexpr int kBM = 128;          // rows of a tile
constexpr int kBN = 128;          // columns of a tile
constexpr int kBK = 16;           // depth of a staged chunk
constexpr int kThreads = 256;     // 16 x 16, 8 x 8 products each; two
                                  // blocks an SM (128 registers a thread)
constexpr int kStride = kBM + 4;  // a chunk's row stride in shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and read back (the plain version's `.to(dtype).float()`)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// elements [c, c + 4) of row `row` of a row-major (rows, ld) array as f32,
// 0 past `rows` rows and `cols` columns: one 16-byte (f32) or 8-byte (bf16)
// load where ld is a multiple of 4 (c is, and the wrapper's tensors start
// on 16 bytes)
__device__ __forceinline__ void load4(float* r, const float* __restrict__ src,
                                      int rows, int ld, int cols, int row,
                                      int c) {
  if ((ld & 3) == 0 && row < rows && c + 3 < cols) {
    const float4 x =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)row * ld + c));
    r[0] = x.x;
    r[1] = x.y;
    r[2] = x.z;
    r[3] = x.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = row < rows && c + i < cols ? __ldg(src + (size_t)row * ld + c + i)
                                      : 0.f;
}

__device__ __forceinline__ void load4(float* r,
                                      const __nv_bfloat16* __restrict__ src,
                                      int rows, int ld, int cols, int row,
                                      int c) {
  if ((ld & 3) == 0 && row < rows && c + 3 < cols) {
    const uint2 x =
        __ldg(reinterpret_cast<const uint2*>(src + (size_t)row * ld + c));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    r[0] = __low2float(lo);
    r[1] = __high2float(lo);
    r[2] = __low2float(hi);
    r[3] = __high2float(hi);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = row < rows && c + i < cols
               ? to_f(src[(size_t)row * ld + c + i])
               : 0.f;
}

// the values of a chunk each thread loads: kBK x 128 over kThreads
constexpr int kPer = kBK * kBM / kThreads;

// A chunk's loader where the depth runs along the source's rows (rows of
// the tile at row0 + 0..127, depth k contiguous): thread t loads row t / 2,
// depth kPer (t % 2) .. + kPer - 1 of the chunk, and stores them
// transposed
template <typename T>
struct DepthAlongRows {
  const T* src;
  int rows, ld, depth, row0;
  float r[kPer];
  __device__ __forceinline__ void load(int k) {
#pragma unroll
    for (int q = 0; q < kPer; q += 4)
      load4(r + q, src, rows, ld, depth, row0 + (threadIdx.x >> 1),
            k + (threadIdx.x & 1) * kPer + q);
  }
  __device__ __forceinline__ void store(float (*s)[kStride]) {
    const int lr = threadIdx.x >> 1, lc = (threadIdx.x & 1) * kPer;
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[lc + i][lr] = r[i];
  }
};

// A chunk's loader where the depth runs down the source's columns (depth k
// = a row of the source, the tile's 128 columns at col0 contiguous):
// thread t loads depths t / 32 + 8 q (q < kPer / 4), columns 4 (t % 32) ..
// + 3
template <typename T>
struct DepthAlongColumns {
  const T* src;
  int rows, ld, cols, col0;
  float r[kPer];
  __device__ __forceinline__ void load(int k) {
#pragma unroll
    for (int q = 0; q < kPer; q += 4)
      load4(r + q, src, rows, ld, cols, k + (threadIdx.x >> 5) + 2 * q,
            col0 + (threadIdx.x & 31) * 4);
  }
  __device__ __forceinline__ void store(float (*s)[kStride]) {
#pragma unroll
    for (int q = 0; q < kPer; q += 4)
      *reinterpret_cast<float4*>(
          &s[(threadIdx.x >> 5) + 2 * q][(threadIdx.x & 31) * 4]) =
          make_float4(r[q], r[q + 1], r[q + 2], r[q + 3]);
  }
};

// the tile's row (or column) of thread coordinate t and register index i:
// 4 t + i, then 64 + 4 t + i - 4
__device__ __forceinline__ int at(int t, int i) {
  return i < 4 ? t * 4 + i : 64 + t * 4 + i - 4;
}

// acc[i][j] = sum over k in [k0, k1), in order, of A[at(ty, i)][k]
// B[k][at(tx, j)], the A chunk's values rounded to R as they are read;
// chunks of kBK staged through two buffers of as and bs. Every thread of
// the block calls it (it holds barriers; it starts with one, so earlier
// reads of the buffers are done). `each(as_chunk)` runs after each chunk's
// products, on the chunk's unrounded A values (the dW kernel's db).
template <typename R, typename LA, typename LB, typename Each>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], LA& la,
                                             LB& lb, int k0, int k1,
                                             float (*as)[kBK][kStride],
                                             float (*bs)[kBK][kStride],
                                             Each each) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  la.load(k0);
  lb.load(k0);
  __syncthreads();
  la.store(as[0]);
  lb.store(bs[0]);
  __syncthreads();
  int buf = 0;
  for (int k = k0; k < k1; k += kBK) {
    const bool more = k + kBK < k1;
    if (more) {
      la.load(k + kBK);
      lb.load(k + kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float* ak = as[buf][kk];
      const float* bk = bs[buf][kk];
      const float4 a0 = *reinterpret_cast<const float4*>(ak + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(ak + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bk + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bk + 64 + tx * 4);
      const float a[8] = {round_to<R>(a0.x), round_to<R>(a0.y),
                          round_to<R>(a0.z), round_to<R>(a0.w),
                          round_to<R>(a1.x), round_to<R>(a1.y),
                          round_to<R>(a1.z), round_to<R>(a1.w)};
      const float c[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    each(as[buf]);
    if (more) {
      la.store(as[buf ^ 1]);
      lb.store(bs[buf ^ 1]);
      __syncthreads();
      buf ^= 1;
    }
  }
}

// the max (half_warp_max) or the sum (half_warp_sum) of x over the 16
// threads tx of a half-warp (a tile row's 128 columns), the same bits in
// every lane
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Nothing {
  __device__ __forceinline__ void operator()(float (*)[kStride]) const {}
};

// the thread's 8 x 8 outputs at rows row0 + at(ty, i), columns col0 +
// at(tx, j) of a row-major (rows, cols) f32 array: 16-byte stores where
// cols is a multiple of 4
__device__ __forceinline__ void store_tile(const float (&acc)[8][8],
                                           float* __restrict__ out, int rows,
                                           int cols, int row0, int col0) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + at(ty, i);
    if (r >= rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = col0 + at(tx, 4 * half);
      float* dst = out + (size_t)r * cols + c;
      if ((cols & 3) == 0 && c + 3 < cols) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                        acc[i][4 * half + 2], acc[i][4 * half + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < cols) dst[j] = acc[i][4 * half + j];
      }
    }
  }
}

}  // namespace tiled
