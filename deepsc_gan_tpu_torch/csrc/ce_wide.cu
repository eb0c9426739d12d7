// Online-softmax vocab cross-entropy forward (K3) in f32 at any width D,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` of deepsc_gan_tpu/ops/pallas/ce.py
// where the tuned f32 kernel (csrc/ce_fwd.cu: D a multiple of 8 up to 256,
// the whole row of D staged) does not take the width: the JAX kernel takes
// any D, so `--dtype float32` with `--decoder-d-model 512`, 640 or 264 runs
// here (the bf16 forward at those widths is csrc/ce_wide_fwd.cu's, on the
// tensor cores; the backward at them csrc/ce_bwd_tiled.cu's and
// csrc/ce_wide_bwd.cu's). Same function and roundings as the tuned
// kernel: with h (N, D), W (V, D) f32, bias b (V) f32, labels y,
//     lse_n = log sum_v exp(h_n . W_v + b_v),  ce_n = lse_n - (h_n . W_y + b_y)
// with f32 products and f32 sums; the logits never reach device memory.
//
// What bounds it: operations on the CUDA cores (a simple kernel, right
// first). At N = 1,984, D = 512, V = 22,234 the forward is 45 GFLOP (0.7 ms
// at the f32 rate of 67 TFLOP/s).
//
// Design: the tuned f32 kernels' tiles (64 rows of h by 64 vocab rows, 256
// threads each owning a 4 x 4 patch of logits, csrc/wide_tile.cuh), with D
// streamed through shared memory in chunks of 32 columns instead of staged
// whole. Block (row tile, vocab split) keeps a running (max, sum, gold) per
// row over its range of vocab tiles; a second kernel merges the splits of
// each row in order. No atomics: every sum runs in a fixed order, the same
// bits on every call. The kernels allocate nothing; the caller passes the
// outputs and the workspace.

#include "wide_tile.cuh"

namespace {

using wide::KC;
using wide::kCStride;
using wide::kThreads;
using wide::NEG;
using wide::TN;
using wide::TV;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_wide_kernel(const T* __restrict__ h, const T* __restrict__ w,
                   const float* __restrict__ b,
                   const int* __restrict__ labels, float* __restrict__ part,
                   int n, int d, int v, int tiles_per_split) {
  __shared__ float hs[TN * kCStride];
  __shared__ float ws[TV * kCStride];
  __shared__ float red[3 * TN * 16];

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * TN;
  const int split = blockIdx.y;
  const int nvt = (v + TV - 1) / TV;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, nvt);

  int lab[4];
  float m[4], s[4], gold[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    lab[i] = r < n ? labels[r] : -1;
    m[i] = NEG;
    s[i] = 0.f;
    gold[i] = 0.f;
  }
  for (int t = t0; t < t1; ++t) {
    const int col0 = t * TV;
    float acc[4][4];
    wide::tile_logits(h, w, n, v, d, row0, col0, hs, ws, ty, tx, acc);
    if (col0 + tx >= v) continue;  // this thread owns no column of the tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float cm = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c < v) {
          acc[i][j] += b[c];
          cm = fmaxf(cm, acc[i][j]);
          if (c == lab[i]) gold[i] = acc[i][j];
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

  // merge the 16 column partials of each row (threads tx = 0..15)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    red[(0 * TN + r) * 16 + tx] = m[i];
    red[(1 * TN + r) * 16 + tx] = s[i];
    red[(2 * TN + r) * 16 + tx] = gold[i];
  }
  __syncthreads();
  if (threadIdx.x < TN) {
    const int r = threadIdx.x;
    const int row = row0 + r;
    float mm = NEG;
    for (int x = 0; x < 16; ++x) mm = fmaxf(mm, red[(0 * TN + r) * 16 + x]);
    float ss = 0.f, gg = 0.f;
    for (int x = 0; x < 16; ++x) {
      ss += red[(1 * TN + r) * 16 + x] * expf(red[(0 * TN + r) * 16 + x] - mm);
      gg += red[(2 * TN + r) * 16 + x];
    }
    if (row < n) {
      float* out = part + ((size_t)split * n + row) * 3;
      out[0] = mm;
      out[1] = ss;
      out[2] = gg;
    }
  }
}

// one thread per row: merge the splits in order; lse = m + log(s),
// ce = lse - gold
__global__ void ce_fwd_wide_combine_kernel(const float* __restrict__ part,
                                           float* __restrict__ ce_out,
                                           float* __restrict__ lse_out,
                                           int n, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float mm = NEG;
  for (int sp = 0; sp < splits; ++sp)
    mm = fmaxf(mm, part[((size_t)sp * n + row) * 3]);
  float ss = 0.f, gg = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = part + ((size_t)sp * n + row) * 3;
    ss += p[1] * expf(p[0] - mm);
    gg += p[2];
  }
  const float lse = mm + logf(ss);
  lse_out[row] = lse;
  ce_out[row] = lse - gg;
}

template <typename T>
int launch_fwd(const void* h, const void* w, const void* b,
               const void* labels, void* ce_out, void* lse_out, void* part,
               int n, int d, int v, int splits, void* stream) {
  const int tps = wide::split_tiles(n, d, v, splits);
  if (tps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ce_fwd_wide_kernel<T><<<dim3((n + TN - 1) / TN, splits), kThreads, 0,
                          st>>>((const T*)h, (const T*)w, (const float*)b,
                                (const int*)labels, (float*)part, n, d, v,
                                tps);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  ce_fwd_wide_combine_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)part, (float*)ce_out, (float*)lse_out, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (rows of h per tile, vocab rows per tile, blocks of the forward kernel
// per SM) into out[3], on the current device: what the wrapper cuts the
// vocab into splits by.
int deepsc_ce_wide_tiling_f32(int d, int* out) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  return wide::tiling((const void*)ce_fwd_wide_kernel<float>, out);
}

// h: contiguous f32 (N, D), any D >= 1; w: contiguous f32 (V, D); b:
// f32 (V); labels: int32 (N); ce_out, lse_out: f32 (N); part: f32 workspace
// (splits, N, 3). Every split must own at least one vocab tile of 64 rows.
// Returns cudaGetLastError() after the launches (0 = success).
int deepsc_ce_wide_fwd_f32(const void* h, const void* w, const void* b,
                           const void* labels, void* ce_out, void* lse_out,
                           void* part, int n, int d, int v, int splits,
                           void* stream) {
  return launch_fwd<float>(h, w, b, labels, ce_out, lse_out, part, n, d, v,
                           splits, stream);
}

}  // extern "C"
