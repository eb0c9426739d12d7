// Online-softmax vocab cross-entropy forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `_fwd_kernel` of deepsc_gan_tpu/ops/pallas/ce.py
// (reached through `pallas_softmax_xent` / `fused_ce_loss`). For each row n
// of h (N, D) with label y_n, over the vocab table W (V, D) and bias b (V)
//     lse_n = log sum_v exp(h_n . W_v + b_v),   ce_n = lse_n - (h_n . W_y + b_y)
// with f32 products and sums of operands in h's type (f32, or bf16 on the
// training path). The (N, V) logits never reach device memory: each block
// recomputes 64 x 64 tiles of them in registers and keeps a running max and
// a rescaled sum of exponentials, as the TPU kernel does over its vocab grid
// axis. The TPU kernel pads W and b to a whole number of vocab tiles (bias
// -1e30 on the padding, a copy of the table per call); here the last tile
// is bound-checked instead, which gives the same sums: a padded column adds
// exp(-1e30 - m) = 0.
//
// What bounds it: operations. At the training path (N = 64 x 31 = 1,984,
// D = 128, V = 22,234, bf16) one call does 2 N D V = 11.3 GFLOP (11 us at
// the bf16 tensor-core rate) and reads 6.2 MB (2 us at 3.35 TB/s). This
// first version multiplies on the f32 CUDA cores (67 TFLOP/s: 0.17 ms at
// best); tensor cores (wgmma) are later work.
//
// Design: the TPU kernel's grid runs its vocab axis in order on one core;
// here blocks run in parallel, so the vocab axis is cut into `splits`
// contiguous ranges. Block (row tile, split) stages its 64 rows of h once,
// walks its range of 64-row vocab tiles of W through shared memory, and
// each thread keeps, for its 4 rows, a running max, sum of exponentials and
// gold logit over the columns it owns. The 16 partials of a row are merged
// in the block, and one (max, sum, gold) per (split, row) goes to a
// workspace; a second kernel merges the splits of each row in order and
// writes ce and lse. No atomics: the result is deterministic.

#include "ce_tile.cuh"

namespace {

using ce::kThreads;
using ce::NEG;
using ce::TN;
using ce::TV;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_partial_kernel(const T* __restrict__ h, const T* __restrict__ w,
                      const float* __restrict__ b,
                      const int* __restrict__ labels,
                      float* __restrict__ part, int n, int d, int v,
                      int tiles_per_split) {
  extern __shared__ float smem[];
  const int stride = d + 1;
  float* hs = smem;              // TN x stride
  float* ws = hs + TN * stride;  // TV x stride
  float* red = ws + TV * stride; // 3 x TN x 16 partials

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * TN;
  const int split = blockIdx.y;
  const int nvt = (v + TV - 1) / TV;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, nvt);

  ce::stage_rows(h, n, row0, TN, d, hs);
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
__global__ void ce_fwd_combine_kernel(const float* __restrict__ part,
                                      float* __restrict__ ce_out,
                                      float* __restrict__ lse_out, int n,
                                      int splits) {
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

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)(TN + TV) * (d + 1) + 3 * TN * 16);
}

template <typename T>
int launch(const void* h, const void* w, const void* b, const void* labels,
           void* ce_out, void* lse_out, void* part, int n, int d, int v,
           int splits, void* stream) {
  if (n <= 0 || v <= 0 || d <= 0 || d > ce::kMaxD ||
      d % (16 / (int)sizeof(T)) || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int nvt = (v + TV - 1) / TV;
  const int tps = (nvt + splits - 1) / splits;
  if ((splits - 1) * tps >= nvt) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ce_fwd_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + TN - 1) / TN, splits);
  cudaStream_t st = (cudaStream_t)stream;
  ce_fwd_partial_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)h, (const T*)w, (const float*)b, (const int*)labels,
      (float*)part, n, d, v, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)part, (float*)ce_out, (float*)lse_out, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the partial kernel needs.
size_t deepsc_ce_fwd_smem_bytes(int d) { return smem_bytes(d); }

// h: contiguous f32 (N, D); w: contiguous f32 (V, D); b: f32 (V); labels:
// int32 (N); ce_out, lse_out: f32 (N); part: f32 workspace (splits, N, 3).
// Every split must own at least one vocab tile of 64 rows. Returns
// cudaGetLastError() after the launches (0 = success).
int deepsc_ce_fwd_f32(const void* h, const void* w, const void* b,
                      const void* labels, void* ce_out, void* lse_out,
                      void* part, int n, int d, int v, int splits,
                      void* stream) {
  return launch<float>(h, w, b, labels, ce_out, lse_out, part, n, d, v,
                       splits, stream);
}

// As above with h and w in bf16.
int deepsc_ce_fwd_bf16(const void* h, const void* w, const void* b,
                       const void* labels, void* ce_out, void* lse_out,
                       void* part, int n, int d, int v, int splits,
                       void* stream) {
  return launch<__nv_bfloat16>(h, w, b, labels, ce_out, lse_out, part, n, d,
                               v, splits, stream);
}

}  // extern "C"
