// Online-softmax vocab cross-entropy, forward and backward, at any width D,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_fwd_kernel`, `_dh_kernel` and `_dw_kernel` of
// deepsc_gan_tpu/ops/pallas/ce.py where the tuned kernels (csrc/ce_fwd.cu,
// csrc/ce_bwd.cu: D a multiple of 16 (bf16, one wgmma k-step) or 8 (f32)
// up to 256, the whole row of D staged or held in registers) do not take
// the width: the JAX kernels take any D, so `--decoder-d-model 512` or 200
// runs here in f32 (in bf16 the forward is csrc/ce_wide_fwd.cu's and the
// backward up to 5,120 columns csrc/ce_wide_bwd.cu's, on the tensor cores).
// Same functions and roundings as the tuned kernels: with h
// (N, D), W (V, D) of one type T, bias b (V) f32, labels y,
//     lse_n = log sum_v exp(h_n . W_v + b_v),  ce_n = lse_n - (h_n . W_y + b_y)
//     P_nv = exp(h_n . W_v + b_v - lse_n) g_n - [v == y_n] g_n       (f32)
//     dh = Pc W,  dW = Pc^T h,  db = sum_n P    (Pc: P rounded to T)
// with f32 products (exact for bf16 operands) and f32 sums; the logits
// never reach device memory. With dW and db not asked for, dh alone (K4's
// dh-only mode).
//
// What bounds it: operations on the CUDA cores (a simple kernel, right
// first). At N = 1,984, D = 512, V = 22,234 the forward is 45 GFLOP (46 us
// at the bf16 tensor-core rate, 0.7 ms at the f32 rate these kernels run
// at); the backward recomputes the logits once per 256 columns of D it
// writes.
//
// Design: the tuned f32 kernels' tiles (64 rows of h by 64 vocab rows, 256
// threads each owning a 4 x 4 patch of logits, csrc/wide_tile.cuh), with D
// streamed through shared memory in chunks of 32 columns instead of staged
// whole, and T converted to f32 as it is staged. Forward: block (row tile,
// vocab split) keeps a running (max, sum, gold) per row over its range of
// vocab tiles; a second kernel merges the splits of each row in order.
// Backward: dh from block (row tile, vocab split, 256-column slab of D):
// per vocab tile the logits and P (shared tile, f32), then Pc times the
// tile's W slab, chunk by chunk; the splits' partials added in order by a
// third kernel. dW and db from block (vocab tile, slab of D), walking every
// row tile in order; db (unrounded P) by the first slab's blocks. In bf16
// only the backward past 5,120 columns runs here. No
// atomics: every sum runs in a fixed order, the same bits on every call.
// The kernels allocate nothing; the caller passes the outputs and the
// workspaces.

#include <type_traits>

#include "wide_tile.cuh"

namespace {

using wide::KC;
using wide::kCStride;
using wide::kThreads;
using wide::NEG;
using wide::TN;
using wide::TV;

constexpr int DO = 256;             // columns of dh / dW a block writes
constexpr int kDPer = DO / 16;      // of them per thread
constexpr int kChunks = DO / KC;    // staged chunks per slab
constexpr int kPStride = TV + 1;    // row stride of the P tile
// the widest bf16 D the tensor-core backward (csrc/ce_wide_bwd.cu) takes
constexpr int kMaxTensorCoreD = 5120;

// ---- forward ----

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

// ---- backward ----

// P (f32, unrounded) of the thread's 4 x 4 logits (rows row0 + ty + 16 i,
// columns col0 + tx + 16 j) into the shared tile pt; zero off the ragged
// edges
__device__ __forceinline__ void tile_p(float acc[4][4],
                                       const float* __restrict__ b,
                                       const int* lab, const float* lse,
                                       const float* g, int row0, int col0,
                                       int n, int v, int ty, int tx,
                                       float* pt) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool row_ok = row0 + ty + 16 * i < n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      float p = 0.f;
      if (row_ok && c < v) {
        p = expf(acc[i][j] + b[c] - lse[i]) * g[i];
        if (c == lab[i]) p -= g[i];
      }
      pt[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
    }
  }
}

// labels, lse and cotangent of the rows row0 + ty + 16 i
__device__ __forceinline__ void row_info(const int* __restrict__ labels,
                                         const float* __restrict__ lse_in,
                                         const float* __restrict__ g_in,
                                         int row0, int n, int ty, int lab[4],
                                         float lse[4], float g[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    const bool ok = r < n;
    lab[i] = ok ? labels[r] : -1;
    lse[i] = ok ? lse_in[r] : 0.f;
    g[i] = ok ? g_in[r] : 0.f;
  }
}

// dh partials: block (row tile, vocab split, slab of DO columns of D);
// thread (ty, tx) accumulates rows row0 + ty + 16 i, columns o0 + tx + 16 k
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dh_wide_kernel(const T* __restrict__ h, const T* __restrict__ w,
                  const float* __restrict__ b, const int* __restrict__ labels,
                  const float* __restrict__ lse_in,
                  const float* __restrict__ g_in,
                  float* __restrict__ dh_part, int n, int d, int v,
                  int tiles_per_split) {
  __shared__ float hs[TN * kCStride];
  __shared__ float ws[TV * kCStride];
  __shared__ float pt[TN * kPStride];

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * TN;
  const int split = blockIdx.y;
  const int o0 = blockIdx.z * DO;
  const int nvt = (v + TV - 1) / TV;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, nvt);

  int lab[4];
  float lse[4], g[4];
  row_info(labels, lse_in, g_in, row0, n, ty, lab, lse, g);
  float dha[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < kDPer; ++k) dha[i][k] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int col0 = t * TV;
    float acc[4][4];
    wide::tile_logits(h, w, n, v, d, row0, col0, hs, ws, ty, tx, acc);
    tile_p(acc, b, lab, lse, g, row0, col0, n, v, ty, tx, pt);
    // dh[r][c0 + k] += sum_c Pc[r][c] W[col0 + c][c0 + k], the slab's W
    // staged a chunk at a time (rows past V and columns past D as 0)
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      const int c0 = o0 + cc * KC;
      if (c0 < d) {  // the same for every thread of the block
        __syncthreads();  // pt written; the last reads of ws done
        wide::stage_chunk(w, v, col0, TV, d, c0, ws);
        __syncthreads();
        for (int c = 0; c < TV; ++c) {
          float p[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            p[i] = wide::round_to<T>(pt[(ty + 16 * i) * kPStride + c]);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float wv = ws[c * kCStride + tx + 16 * u];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dha[i][2 * cc + u] = fmaf(p[i], wv, dha[i][2 * cc + u]);
          }
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
    for (int k = 0; k < kDPer; ++k) {
      const int col = o0 + tx + 16 * k;
      if (col < d) out[col] = dha[i][k];
    }
  }
}

// dh = sum over splits 0..S-1 of the partials, in order
__global__ void ce_dh_wide_sum_kernel(const float* __restrict__ dh_part,
                                      float* __restrict__ dh, int n, int d,
                                      int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)n * d;
  if (e >= total) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += dh_part[sp * total + e];
  dh[e] = acc;
}

// dW and db: block (vocab tile, slab of DO columns of D) walks every row
// tile in order; thread (ty, tx) accumulates dW rows col0 + ty + 16 i,
// columns o0 + tx + 16 k; thread c < TV of the first slab db[col0 + c]
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dw_wide_kernel(const T* __restrict__ h, const T* __restrict__ w,
                  const float* __restrict__ b, const int* __restrict__ labels,
                  const float* __restrict__ lse_in,
                  const float* __restrict__ g_in, float* __restrict__ dw,
                  float* __restrict__ db, int n, int d, int v) {
  __shared__ float hs[TN * kCStride];
  __shared__ float ws[TV * kCStride];
  __shared__ float pt[TN * kPStride];

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int col0 = blockIdx.x * TV;
  const int o0 = blockIdx.y * DO;
  float dwa[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < kDPer; ++k) dwa[i][k] = 0.f;
  float dba = 0.f;

  for (int row0 = 0; row0 < n; row0 += TN) {
    int lab[4];
    float lse[4], g[4];
    row_info(labels, lse_in, g_in, row0, n, ty, lab, lse, g);
    float acc[4][4];
    wide::tile_logits(h, w, n, v, d, row0, col0, hs, ws, ty, tx, acc);
    tile_p(acc, b, lab, lse, g, row0, col0, n, v, ty, tx, pt);
    // dW[c][c0 + k] += sum_r Pc[r][c] h[r][c0 + k], h's slab staged a chunk
    // at a time (rows past N as 0)
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      const int c0 = o0 + cc * KC;
      if (c0 < d) {  // the same for every thread of the block
        __syncthreads();  // pt written; the last reads of hs done
        wide::stage_chunk(h, n, row0, TN, d, c0, hs);
        __syncthreads();
        if (cc == 0 && blockIdx.y == 0 && threadIdx.x < TV)
          for (int r = 0; r < TN; ++r) dba += pt[r * kPStride + threadIdx.x];
        for (int r = 0; r < TN; ++r) {
          float p[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            p[i] = wide::round_to<T>(pt[r * kPStride + ty + 16 * i]);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float hv = hs[r * kCStride + tx + 16 * u];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dwa[i][2 * cc + u] = fmaf(p[i], hv, dwa[i][2 * cc + u]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = col0 + ty + 16 * i;
    if (c >= v) continue;
    float* out = dw + (size_t)c * d;
#pragma unroll
    for (int k = 0; k < kDPer; ++k) {
      const int col = o0 + tx + 16 * k;
      if (col < d) out[col] = dwa[i][k];
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < TV && col0 + (int)threadIdx.x < v)
    db[col0 + threadIdx.x] = dba;
}

unsigned slabs(int d) { return (unsigned)((d + DO - 1) / DO); }

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

template <typename T>
int launch_bwd(const void* h, const void* w, const void* b,
               const void* labels, const void* lse, const void* g, void* dh,
               void* dw, void* db, void* dh_part, int n, int d, int v,
               int splits, void* stream) {
  const int tps = wide::split_tiles(n, d, v, splits);
  if (tps < 0 || (dw == nullptr) != (db == nullptr))
    return (int)cudaErrorInvalidValue;
  // bf16 up to 4,096 columns: the tensor-core kernels of
  // csrc/ce_wide_bwd.cu
  if (std::is_same<T, __nv_bfloat16>::value && d <= kMaxTensorCoreD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ce_dh_wide_kernel<T>
      <<<dim3((n + TN - 1) / TN, splits, slabs(d)), kThreads, 0, st>>>(
          (const T*)h, (const T*)w, (const float*)b, (const int*)labels,
          (const float*)lse, (const float*)g, (float*)dh_part, n, d, v, tps);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t total = (size_t)n * d;
  ce_dh_wide_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float*)dh_part, (float*)dh, n, d, splits);
  err = (int)cudaGetLastError();
  if (err || dw == nullptr) return err;
  ce_dw_wide_kernel<T><<<dim3((v + TV - 1) / TV, slabs(d)), kThreads, 0,
                         st>>>((const T*)h, (const T*)w, (const float*)b,
                               (const int*)labels, (const float*)lse,
                               (const float*)g, (float*)dw, (float*)db, n, d,
                               v);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (rows of h per tile, vocab rows per tile, blocks of the dh kernel per SM)
// into out[3], on the current device: what the wrappers cut the vocab into
// splits by, for the forward and the backward alike (bf16: the backward
// past 5,120 columns).
int deepsc_ce_wide_tiling_f32(int d, int* out) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  return wide::tiling((const void*)ce_dh_wide_kernel<float>, out);
}

int deepsc_ce_wide_tiling_bf16(int d, int* out) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  return wide::tiling((const void*)ce_dh_wide_kernel<__nv_bfloat16>, out);
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

// As the forward, with lse, g: f32 (N); dh: f32 (N, D); dw: f32 (V, D) and
// db: f32 (V), or both null for dh alone; dh_part: f32 workspace (splits,
// N, D).
int deepsc_ce_wide_bwd_f32(const void* h, const void* w, const void* b,
                           const void* labels, const void* lse, const void* g,
                           void* dh, void* dw, void* db, void* dh_part, int n,
                           int d, int v, int splits, void* stream) {
  return launch_bwd<float>(h, w, b, labels, lse, g, dh, dw, db, dh_part, n,
                           d, v, splits, stream);
}

int deepsc_ce_wide_bwd_bf16(const void* h, const void* w, const void* b,
                            const void* labels, const void* lse,
                            const void* g, void* dh, void* dw, void* db,
                            void* dh_part, int n, int d, int v, int splits,
                            void* stream) {
  return launch_bwd<__nv_bfloat16>(h, w, b, labels, lse, g, dh, dw, db,
                                   dh_part, n, d, v, splits, stream);
}

}  // extern "C"
