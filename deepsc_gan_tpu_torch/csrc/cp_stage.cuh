// cp.async staging shared by the tiled f32 attention kernels
// (csrc/attention_tiled.cu, csrc/attention_bwd_tiled.cu): a tile of a
// row-major f32 source copied into shared memory by every thread of the
// block, 16 bytes a copy where the rows allow it, with zeros past the
// source's valid rows and columns, asynchronously (commit, then wait).

#pragma once

#include <cuda_runtime.h>

namespace cps {

// row stride in shared memory (floats) of a chunk of DC columns: a
// multiple of 4 for 16-byte copies, and 4 past one so that a
// quarter-warp's 16-byte reads of 8 rows fall in distinct banks
__host__ __device__ constexpr int row_stride(int dc) { return dc + 4; }

// `bytes` (4 or 16) from global to shared memory, asynchronously; zeros
// where !ok
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, rows) x columns [0, cols) of a row-major source at row stride
// `ld` into shared memory at row stride `ds`, by all kThreads threads of
// the block: zeros past `valid_rows` rows and `valid_cols` columns. kVec:
// 16-byte copies (the columns and the source's stride and offset multiples
// of 4), else 4-byte ones.
template <int kThreads, bool kVec>
__device__ __forceinline__ void stage(float* dst, int ds, const float* src,
                                      long long ld, int rows, int cols,
                                      int valid_rows, int valid_cols) {
  if (kVec) {
    const int groups = cols / 4;
    for (int e = threadIdx.x; e < rows * groups; e += kThreads) {
      const int r = e / groups, c = (e - r * groups) * 4;
      const bool ok = r < valid_rows && c < valid_cols;
      cp_async<16>(dst + r * ds + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      const bool ok = r < valid_rows && c < valid_cols;
      cp_async<4>(dst + r * ds + c, ok ? src + r * ld + c : src, ok);
    }
  }
}

}  // namespace cps
