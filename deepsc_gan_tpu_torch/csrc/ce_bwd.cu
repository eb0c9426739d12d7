// Online-softmax vocab cross-entropy backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernels `_dh_kernel` and `_dw_kernel` of
// deepsc_gan_tpu/ops/pallas/ce.py (the custom VJP of
// `pallas_softmax_xent`). With h (N, D), the vocab table W (V, D), bias b
// (V), labels y, the forward's lse (N) and the cotangent g (N) of ce,
//     P_nv = exp(h_n . W_v + b_v - lse_n) g_n - [v == y_n] g_n      (f32)
//     dh = Pc W (N, D),   dW = Pc^T h (V, D),   db = sum_n P_nv (V)
// all three in f32, where Pc is P rounded to the operand type before the
// products and the sums run in f32, as in the TPU kernels. The logits are
// recomputed tile by tile and never reach device memory. Rows past N have a
// zero cotangent and columns past V do not exist (the TPU kernels pad them
// with bias -1e30, which gives P = 0 there).
//
// What bounds it: operations. At the training path (N = 1,984, D = 128,
// V = 22,234, bf16) the two products and the two logit recomputations are
// 4 x N D V = 22.6 G multiply-adds (45 GFLOP: 46 us at the bf16
// tensor-core rate), against 6.7 MB read and 11.5 MB written (5 us at
// 3.35 TB/s). This first version multiplies on the f32 CUDA cores;
// tensor cores (wgmma) are later work.
//
// Design: two kernels, like the TPU's, because each product sums over a
// different axis and Hopper's blocks cannot carry a sum from one to the
// next. (The TPU's lax.scan backward computes both products from one
// logits recompute; on the card that would need atomics or an
// (N/64 x N x D) workspace for dh.)
// - dh: block (row tile, vocab split) stages its 64 rows of h once, walks
//   its range of vocab tiles, forms Pc in shared memory and accumulates
//   Pc W in registers (thread (ty, tx) owns rows ty + 16 i, columns
//   tx + 16 t of D); a third small kernel adds the splits' partials in
//   order.
// - dW, db: block (vocab tile) stages its 64 rows of W once and walks every
//   row tile of h, accumulating Pc^T h in registers and sum_n P in one
//   thread per vocab row, in row order.
// No atomics: the result is deterministic.

#include "ce_tile.cuh"

namespace {

using ce::kThreads;
using ce::TN;
using ce::TV;
using ce::round_to;

constexpr int kDPer = ce::kMaxD / 16;  // columns of D per thread
constexpr int kPStride = TV + 1;       // row stride of the P tile

// P for the thread's 4 x 4 logits (rows row0 + ty + 16 i, columns
// col0 + tx + 16 j), in f32; zero off the ragged edges
__device__ __forceinline__ void tile_p(float acc[4][4], const float* b,
                                       const int* lab, const float* lse,
                                       const float* g, int row0, int col0,
                                       int n, int v, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool row_ok = row0 + ty + 16 * i < n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (row_ok && c < v) {
        float p = expf(acc[i][j] + b[c] - lse[i]) * g[i];
        if (c == lab[i]) p -= g[i];
        acc[i][j] = p;
      } else {
        acc[i][j] = 0.f;
      }
    }
  }
}

// labels, lse and cotangent of the thread's rows row0 + ty + 16 i
__device__ __forceinline__ void row_info(const int* labels,
                                         const float* lse_in,
                                         const float* g_in, int row0, int n,
                                         int ty, int lab[4], float lse[4],
                                         float g[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    const bool ok = r < n;
    lab[i] = ok ? labels[r] : -1;
    lse[i] = ok ? lse_in[r] : 0.f;
    g[i] = ok ? g_in[r] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dh_kernel(const T* __restrict__ h, const T* __restrict__ w,
             const float* __restrict__ b, const int* __restrict__ labels,
             const float* __restrict__ lse_in, const float* __restrict__ g_in,
             float* __restrict__ dh_part, int n, int d, int v,
             int tiles_per_split) {
  extern __shared__ float smem[];
  const int stride = d + 1;
  float* hs = smem;              // TN x stride
  float* ws = hs + TN * stride;  // TV x stride
  float* pt = ws + TV * stride;  // TN x kPStride: Pc

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * TN;
  const int split = blockIdx.y;
  const int nvt = (v + TV - 1) / TV;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, nvt);

  ce::stage_rows(h, n, row0, TN, d, hs);
  int lab[4];
  float lse[4], g[4];
  row_info(labels, lse_in, g_in, row0, n, ty, lab, lse, g);
  float dha[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < kDPer; ++t) dha[i][t] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int col0 = t * TV;
    __syncthreads();  // the previous tile's reads of ws and pt are done
    ce::stage_rows(w, v, col0, TV, d, ws);
    __syncthreads();
    float acc[4][4];
    ce::tile_logits(hs, ws, d, ty, tx, acc);
    tile_p(acc, b, lab, lse, g, row0, col0, n, v, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pt[(ty + 16 * i) * kPStride + tx + 16 * j] = round_to<T>(acc[i][j]);
    __syncthreads();
    // dh[r][k] += sum_c Pc[r][c] W[c][k]; W rows past V are staged as 0
    for (int c = 0; c < TV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pt[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int k = 0; k < kDPer; ++k) {
        if (tx + 16 * k < d) {
          const float wv = ws[c * stride + tx + 16 * k];
#pragma unroll
          for (int i = 0; i < 4; ++i) dha[i][k] = fmaf(p[i], wv, dha[i][k]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
    float* out = dh_part + ((size_t)split * n + r) * d;
#pragma unroll
    for (int k = 0; k < kDPer; ++k)
      if (tx + 16 * k < d) out[tx + 16 * k] = dha[i][k];
  }
}

// dh = sum over splits 0..S-1 of the partials, in order
__global__ void ce_dh_sum_kernel(const float* __restrict__ dh_part,
                                 float* __restrict__ dh, int n, int d,
                                 int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)n * d;
  if (e >= total) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += dh_part[sp * total + e];
  dh[e] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dw_kernel(const T* __restrict__ h, const T* __restrict__ w,
             const float* __restrict__ b, const int* __restrict__ labels,
             const float* __restrict__ lse_in, const float* __restrict__ g_in,
             float* __restrict__ dw, float* __restrict__ db, int n, int d,
             int v) {
  extern __shared__ float smem[];
  const int stride = d + 1;
  float* hs = smem;              // TN x stride
  float* ws = hs + TN * stride;  // TV x stride
  float* pt = ws + TV * stride;  // TN x kPStride: P in f32

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int col0 = blockIdx.x * TV;
  ce::stage_rows(w, v, col0, TV, d, ws);

  // thread (ty, tx) accumulates dW rows col0 + ty + 16 i, columns
  // tx + 16 k of D; thread c < TV accumulates db[col0 + c]
  float dwa[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < kDPer; ++k) dwa[i][k] = 0.f;
  float dba = 0.f;

  for (int row0 = 0; row0 < n; row0 += TN) {
    __syncthreads();  // the previous tile's reads of hs and pt are done
    ce::stage_rows(h, n, row0, TN, d, hs);
    int lab[4];
    float lse[4], g[4];
    row_info(labels, lse_in, g_in, row0, n, ty, lab, lse, g);
    __syncthreads();
    float acc[4][4];
    ce::tile_logits(hs, ws, d, ty, tx, acc);
    tile_p(acc, b, lab, lse, g, row0, col0, n, v, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pt[(ty + 16 * i) * kPStride + tx + 16 * j] = acc[i][j];
    __syncthreads();
    // dW[c][k] += sum_r Pc[r][c] h[r][k]; h rows past N are staged as 0
    for (int r = 0; r < TN; ++r) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = round_to<T>(pt[r * kPStride + ty + 16 * i]);
#pragma unroll
      for (int k = 0; k < kDPer; ++k) {
        if (tx + 16 * k < d) {
          const float hv = hs[r * stride + tx + 16 * k];
#pragma unroll
          for (int i = 0; i < 4; ++i) dwa[i][k] = fmaf(p[i], hv, dwa[i][k]);
        }
      }
    }
    if (threadIdx.x < TV)
      for (int r = 0; r < TN; ++r) dba += pt[r * kPStride + threadIdx.x];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = col0 + ty + 16 * i;
    if (c >= v) continue;
    float* out = dw + (size_t)c * d;
#pragma unroll
    for (int k = 0; k < kDPer; ++k)
      if (tx + 16 * k < d) out[tx + 16 * k] = dwa[i][k];
  }
  if (threadIdx.x < TV && col0 + (int)threadIdx.x < v)
    db[col0 + threadIdx.x] = dba;
}

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)(TN + TV) * (d + 1) + TN * kPStride);
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch(const void* h, const void* w, const void* b, const void* labels,
           const void* lse, const void* g, void* dh, void* dw, void* db,
           void* dh_part, int n, int d, int v, int splits, void* stream) {
  if (n <= 0 || v <= 0 || d <= 0 || d > ce::kMaxD ||
      d % (16 / (int)sizeof(T)) || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int nvt = (v + TV - 1) / TV;
  const int tps = (nvt + splits - 1) / splits;
  if ((splits - 1) * tps >= nvt) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  int err = set_smem((const void*)ce_dh_kernel<T>, smem);
  if (err) return err;
  err = set_smem((const void*)ce_dw_kernel<T>, smem);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid_dh((n + TN - 1) / TN, splits);
  ce_dh_kernel<T><<<grid_dh, kThreads, smem, st>>>(
      (const T*)h, (const T*)w, (const float*)b, (const int*)labels,
      (const float*)lse, (const float*)g, (float*)dh_part, n, d, v, tps);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t total = (size_t)n * d;
  ce_dh_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float*)dh_part, (float*)dh, n, d, splits);
  err = (int)cudaGetLastError();
  if (err) return err;
  ce_dw_kernel<T><<<nvt, kThreads, smem, st>>>(
      (const T*)h, (const T*)w, (const float*)b, (const int*)labels,
      (const float*)lse, (const float*)g, (float*)dw, (float*)db, n, d, v);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of either product kernel needs.
size_t deepsc_ce_bwd_smem_bytes(int d) { return smem_bytes(d); }

// h: contiguous f32 (N, D); w: contiguous f32 (V, D); b, db: f32 (V);
// labels: int32 (N); lse, g: f32 (N); dh: f32 (N, D); dw: f32 (V, D);
// dh_part: f32 workspace (splits, N, D). Every split must own at least one
// vocab tile of 64 rows. Returns cudaGetLastError() after the launches
// (0 = success).
int deepsc_ce_bwd_f32(const void* h, const void* w, const void* b,
                      const void* labels, const void* lse, const void* g,
                      void* dh, void* dw, void* db, void* dh_part, int n,
                      int d, int v, int splits, void* stream) {
  return launch<float>(h, w, b, labels, lse, g, dh, dw, db, dh_part, n, d, v,
                       splits, stream);
}

// As above with h and w in bf16.
int deepsc_ce_bwd_bf16(const void* h, const void* w, const void* b,
                       const void* labels, const void* lse, const void* g,
                       void* dh, void* dw, void* db, void* dh_part, int n,
                       int d, int v, int splits, void* stream) {
  return launch<__nv_bfloat16>(h, w, b, labels, lse, g, dh, dw, db, dh_part,
                               n, d, v, splits, stream);
}

}  // extern "C"
