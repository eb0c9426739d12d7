// Online-softmax vocab cross-entropy backward (K4) on the CUDA cores of
// Hopper (sm_90a), plain C interface: every f32 width, and bf16 past the
// 5,120 columns of the tensor-core wide kernel (csrc/ce_wide_bwd.cu).
//
// Replaces the TPU kernels `_dh_kernel` and `_dw_kernel` of
// deepsc_gan_tpu/ops/pallas/ce.py for every `--dtype float32` call: the main
// model's D = 128 (its dh-only mode in the FGM steps too), the widened
// decoder's 200, the wide-heads model's 640, and any D >= 1. Same function
// and roundings as the plain version: with h (N, D), W (V, D) of one type T,
// bias b (V) f32, labels y, the forward's lse and the cotangent g (N) f32,
//     P_nv = exp((h_n . W_v + b_v) - lse_n) g_n - [v == y_n] g_n     (f32)
//     dh = Pc W,  dW = Pc^T h,  db = sum_n P    (Pc: P rounded to T)
// every product in exact f32 on the CUDA cores (no TF32; exact for bf16
// operands too) and f32 sums.
//
// What bounds it: operations. At N = 1,984, D = 640, V = 22,234 the three
// products are 3 x 2 N D V = 169 GFLOP, 2.53 ms at the f32 CUDA-core rate of
// 67 TFLOP/s; P is 176 MB, written once and read twice (0.16 ms at 3.35
// TB/s). At D = 128 the products are 34 GFLOP (0.51 ms) and P the same
// 176 MB. The designs before this one formed the logits again for each
// product on 64 x 64 tiles of 4 x 4 a thread: past D = 256 for every 256
// columns of dh and of dW they wrote (40.9 ms at D = 640), up to it in a
// dh and a dW kernel (csrc/ce_bwd.cu's f32 path: 3.502 ms at D = 128),
// on an H100 80GB HBM3 at 700 W.
//
// Design: P formed once, into an (NP, VP) f32 workspace the caller passes
// (N and V rounded up to 128; zeros past N and V), then two products that
// read it (the tile loop of csrc/ce_tiled.cuh, which the tiled K3 shares):
// (1) P: block (128 rows of h, 128 vocab rows), the logits h . W_v on the
//     CUDA cores, 8 x 8 a thread, D streamed through shared memory in
//     chunks of 16 columns (the next chunk loaded into registers while this
//     one is multiplied), each sum over d in order 0..D-1 by fmaf; then P
//     from the logits, unrounded.
// (2) dh: block (128 rows, 128 columns of D, vocab split), the same tile
//     loop over the split's vocab rows in order (Pc's chunks staged from
//     the workspace, W's rows as they lie); the splits' partials added in
//     split order by a third kernel (one split: dh written directly).
// (3) dW: block (128 vocab rows, 128 columns of D, row split), the tile
//     loop over the split's rows n in order (P's rows and h's rows as they
//     lie); the blocks of the first 128 columns also sum db = sum_n P
//     (unrounded) in order of n; the splits' partials of dW and db added
//     in split order (one split: written directly). The row splits fill the
//     card's waves where the vocab tiles alone would leave a third of it
//     idle (174 blocks for 264 slots at D = 128). The dh-only mode runs (1)
//     and (2).
// Every output has one writer and a fixed order of sums: no atomics, the
// same bits on every call. The kernels allocate nothing.

#include "ce_tiled.cuh"

namespace {

using namespace tiled;

// (1) block (row tile, vocab tile): P of its 128 x 128 tile into p (NP,
// VP), zero past N rows and V columns
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ce_bwd_tiled_p_kernel(const T* __restrict__ h, const T* __restrict__ w,
                      const float* __restrict__ b,
                      const int* __restrict__ labels,
                      const float* __restrict__ lse,
                      const float* __restrict__ g, float* __restrict__ p,
                      int n, int d, int v, int vp) {
  __shared__ __align__(16) float as[2][kBK][kStride];
  __shared__ __align__(16) float bs[2][kBK][kStride];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  DepthAlongRows<T> la{h, n, d, d, row0};
  DepthAlongRows<T> lb{w, v, d, d, col0};
  float acc[8][8];
  tile_product<float>(acc, la, lb, 0, d, as, bs, Nothing{});
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col0 + at(tx, j);
    bias[j] = c < v ? __ldg(b + c) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + at(ty, i);
    const bool ok = r < n;
    const int lab = ok ? __ldg(labels + r) : -1;
    const float l = ok ? __ldg(lse + r) : 0.f;
    const float gr = ok ? __ldg(g + r) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + at(tx, j);
      float x = 0.f;
      if (ok && c < v) {
        x = __fmul_rn(expf(__fsub_rn(__fadd_rn(acc[i][j], bias[j]), l)),
                      gr);
        if (c == lab) x = __fsub_rn(x, gr);
      }
      acc[i][j] = x;
    }
  }
  store_tile(acc, p, 1 << 30, vp, row0, col0);
}

// (2) block (row tile, column tile of D, vocab split): the split's part of
// dh = Pc W, into dh itself (one split) or its slot of dh_part (splits, N,
// D)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ce_bwd_tiled_dh_kernel(const float* __restrict__ p,
                       const T* __restrict__ w, float* __restrict__ out,
                       int n, int d, int v, int vp, int tiles_per_split) {
  __shared__ __align__(16) float as[2][kBK][kStride];
  __shared__ __align__(16) float bs[2][kBK][kStride];
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int k0 = split * tiles_per_split * kBN;
  const int k1 = min(k0 + tiles_per_split * kBN, vp);
  DepthAlongRows<float> la{p, 1 << 30, vp, vp, row0};
  DepthAlongColumns<T> lb{w, v, d, d, col0};
  float acc[8][8];
  tile_product<T>(acc, la, lb, k0, k1, as, bs, Nothing{});
  store_tile(acc, out + (size_t)split * n * d, n, d, row0, col0);
}

// out = sum over splits 0..S-1 of the partials (S, total), in order: dh's
// over the vocab splits, dW's and db's over the row splits
__global__ void ce_bwd_tiled_sum_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, size_t total,
                                        int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[s * total + e];
  out[e] = acc;
}

// (3) block (vocab tile, column tile of D, row split): the split's part of
// dW = Pc^T h over its rows n in order, into dw itself (one split) or its
// slot of the partials (splits, V, D); the first column tile's blocks also
// the split's part of db = sum_n P, thread c < 128 summing column c of P in
// order of n, into db or its slot of (splits, V)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ce_bwd_tiled_dw_kernel(const float* __restrict__ p,
                       const T* __restrict__ h, float* __restrict__ dw,
                       float* __restrict__ db, int n, int d, int v, int np,
                       int vp, int tiles_per_split) {
  __shared__ __align__(16) float as[2][kBK][kStride];
  __shared__ __align__(16) float bs[2][kBK][kStride];
  const int col0 = blockIdx.x * kBM;  // vocab rows of dW
  const int d0 = blockIdx.y * kBN;
  const int k0 = blockIdx.z * tiles_per_split * kBM;
  const int k1 = min(k0 + tiles_per_split * kBM, np);
  dw += (size_t)blockIdx.z * v * d;
  db += (size_t)blockIdx.z * v;
  DepthAlongColumns<float> la{p, np, vp, vp, col0};
  DepthAlongColumns<T> lb{h, n, d, d, d0};
  const bool sums_db = blockIdx.y == 0 && threadIdx.x < kBM;
  float dba = 0.f;
  const auto each = [&](float (*chunk)[kStride]) {
    if (sums_db) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) dba += chunk[kk][threadIdx.x];
    }
  };
  float acc[8][8];
  tile_product<T>(acc, la, lb, k0, k1, as, bs, each);
  store_tile(acc, dw, v, d, col0, d0);
  if (sums_db && col0 + (int)threadIdx.x < v) db[col0 + threadIdx.x] = dba;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// tiles per split of `tiles` cut into `splits`, or -1 where a split would
// own none
int per_split(int tiles, int splits) {
  const int per = (tiles + splits - 1) / splits;
  return splits <= 0 || (splits - 1) * per >= tiles ? -1 : per;
}

// out = the sum of the S partials (S, total) in order
int sum_splits(const void* part, void* out, size_t total, int splits,
               cudaStream_t st) {
  ce_bwd_tiled_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float*)part, (float*)out, total, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* h, const void* w, const void* b, const void* labels,
           const void* lse, const void* g, void* dh, void* dw, void* db,
           void* p, void* dh_part, void* dw_part, int n, int d, int v,
           int splits, int dw_splits, void* stream) {
  if (n <= 0 || d <= 0 || v <= 0 || (dw == nullptr) != (db == nullptr) ||
      (splits > 1 && dh_part == nullptr) ||
      (dw != nullptr && dw_splits > 1 && dw_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int np = round_up(n, kBM), vp = round_up(v, kBN);
  const int vt = vp / kBN;
  const int tps = per_split(vt, splits);
  const int rps = per_split(np / kBM, dw_splits);
  if (tps < 0 || rps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned dt = (unsigned)((d + kBN - 1) / kBN);
  ce_bwd_tiled_p_kernel<T><<<dim3(np / kBM, vt), kThreads, 0, st>>>(
      (const T*)h, (const T*)w, (const float*)b, (const int*)labels,
      (const float*)lse, (const float*)g, (float*)p, n, d, v, vp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  ce_bwd_tiled_dh_kernel<T><<<dim3(np / kBM, dt, splits), kThreads, 0, st>>>(
      (const float*)p, (const T*)w, (float*)(splits > 1 ? dh_part : dh), n,
      d, v, vp, tps);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (splits > 1) {
    err = sum_splits(dh_part, dh, (size_t)n * d, splits, st);
    if (err) return err;
  }
  if (dw == nullptr) return 0;
  float* dw_out = dw_splits > 1 ? (float*)dw_part : (float*)dw;
  float* db_out = dw_splits > 1 ? dw_out + (size_t)dw_splits * v * d
                                : (float*)db;
  ce_bwd_tiled_dw_kernel<T><<<dim3(vt, dt, dw_splits), kThreads, 0, st>>>(
      (const float*)p, (const T*)h, dw_out, db_out, n, d, v, np, vp, rps);
  err = (int)cudaGetLastError();
  if (err || dw_splits == 1) return err;
  err = sum_splits(dw_out, dw, (size_t)v * d, dw_splits, st);
  if (err) return err;
  return sum_splits(db_out, db, (size_t)v, dw_splits, st);
}

template <typename T>
int tiling(int d, int* out) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  out[0] = kBM;
  out[1] = kBN;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], ce_bwd_tiled_dh_kernel<T>, kThreads, 0);
}

}  // namespace

extern "C" {

// (rows of a tile, columns of a tile, blocks of the dh kernel per SM) into
// out[3], on the current device: what the wrapper cuts the vocab into
// splits by.
int deepsc_ce_bwd_tiled_tiling_f32(int d, int* out) {
  return tiling<float>(d, out);
}

int deepsc_ce_bwd_tiled_tiling_bf16(int d, int* out) {
  return tiling<__nv_bfloat16>(d, out);
}

// h: contiguous (N, D) of T, any D >= 1; w: contiguous (V, D) of T; b, lse,
// g: f32 (V), (N), (N); labels: int32 (N); dh: f32 (N, D); dw: f32 (V, D)
// and db: f32 (V), or both null for dh alone; p: f32 workspace (NP, VP),
// N and V rounded up to 128; dh_part: f32 (splits, N, D), or null for one
// vocab split; dw_part: f32 (dw_splits, V, D) then (dw_splits, V), or null
// for one row split of dW. Every vocab split must own at least one vocab
// tile of 128 rows, every row split at least one tile of 128 rows of h.
// Returns cudaGetLastError() after the launches (0 = success).
int deepsc_ce_bwd_tiled_f32(const void* h, const void* w, const void* b,
                            const void* labels, const void* lse,
                            const void* g, void* dh, void* dw, void* db,
                            void* p, void* dh_part, void* dw_part, int n,
                            int d, int v, int splits, int dw_splits,
                            void* stream) {
  return launch<float>(h, w, b, labels, lse, g, dh, dw, db, p, dh_part,
                       dw_part, n, d, v, splits, dw_splits, stream);
}

int deepsc_ce_bwd_tiled_bf16(const void* h, const void* w, const void* b,
                             const void* labels, const void* lse,
                             const void* g, void* dh, void* dw, void* db,
                             void* p, void* dh_part, void* dw_part, int n,
                             int d, int v, int splits, int dw_splits,
                             void* stream) {
  return launch<__nv_bfloat16>(h, w, b, labels, lse, g, dh, dw, db, p,
                               dh_part, dw_part, n, d, v, splits, dw_splits,
                               stream);
}

}  // extern "C"
