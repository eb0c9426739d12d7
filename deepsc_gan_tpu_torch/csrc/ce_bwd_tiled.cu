// Online-softmax vocab cross-entropy backward (K4) off the tuned widths, on
// the CUDA cores of Hopper (sm_90a), plain C interface: every f32 width the
// tuned kernel (csrc/ce_bwd.cu: D a multiple of 8 up to 256) does not take,
// and bf16 past the 5,120 columns of the tensor-core wide kernel
// (csrc/ce_wide_bwd.cu).
//
// Replaces the TPU kernels `_dh_kernel` and `_dw_kernel` of
// deepsc_gan_tpu/ops/pallas/ce.py at those widths: `--dtype float32` with
// `--decoder-d-model 640` (the wide-heads model), 512 or 264. Same function
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
// TB/s). The design before this one (csrc/ce_wide.cu's backward) formed the
// logits again for every 256 columns of dh and of dW it wrote, 8 x 2 N D V
// at D = 640 on 4 x 4-a-thread tiles, and took 40.9 ms there on an H100
// 80GB HBM3 at 700 W.
//
// Design: P formed once, into an (NP, VP) f32 workspace the caller passes
// (N and V rounded up to 128; zeros past N and V), then two products that
// read it:
// (1) P: block (128 rows of h, 128 vocab rows), the logits h . W_v on the
//     CUDA cores, 8 x 8 a thread, D streamed through shared memory in
//     chunks of 16 columns (the next chunk loaded into registers while this
//     one is multiplied), each sum over d in order 0..D-1 by fmaf; then P
//     from the logits, unrounded.
// (2) dh: block (128 rows, 128 columns of D, vocab split), the same tile
//     loop over the split's vocab rows in order (Pc's chunks staged from
//     the workspace, W's rows as they lie); the splits' partials added in
//     split order by a third kernel (one split: dh written directly).
// (3) dW: block (128 vocab rows, 128 columns of D), the tile loop over the
//     rows n = 0..NP-1 in order (P's rows and h's rows as they lie); the
//     blocks of the first 128 columns also sum db = sum_n P (unrounded) in
//     order of n. The dh-only mode runs (1) and (2).
// Every output has one writer and a fixed order of sums: no atomics, the
// same bits on every call. The kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

// dh = sum over splits 0..S-1 of the partials, in order
__global__ void ce_bwd_tiled_dh_sum_kernel(const float* __restrict__ part,
                                           float* __restrict__ dh,
                                           size_t total, int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[s * total + e];
  dh[e] = acc;
}

// (3) block (vocab tile, column tile of D): dW = Pc^T h over the rows n in
// order; the first column tile's blocks also db = sum_n P, thread c < 128
// summing column c of P in order of n
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ce_bwd_tiled_dw_kernel(const float* __restrict__ p,
                       const T* __restrict__ h, float* __restrict__ dw,
                       float* __restrict__ db, int n, int d, int v, int np,
                       int vp) {
  __shared__ __align__(16) float as[2][kBK][kStride];
  __shared__ __align__(16) float bs[2][kBK][kStride];
  const int col0 = blockIdx.x * kBM;  // vocab rows of dW
  const int d0 = blockIdx.y * kBN;
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
  tile_product<T>(acc, la, lb, 0, np, as, bs, each);
  store_tile(acc, dw, v, d, col0, d0);
  if (sums_db && col0 + (int)threadIdx.x < v) db[col0 + threadIdx.x] = dba;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T>
int launch(const void* h, const void* w, const void* b, const void* labels,
           const void* lse, const void* g, void* dh, void* dw, void* db,
           void* p, void* dh_part, int n, int d, int v, int splits,
           void* stream) {
  if (n <= 0 || d <= 0 || v <= 0 || splits <= 0 ||
      (dw == nullptr) != (db == nullptr) ||
      (splits > 1 && dh_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int np = round_up(n, kBM), vp = round_up(v, kBN);
  const int vt = vp / kBN;
  const int tps = (vt + splits - 1) / splits;
  if ((splits - 1) * tps >= vt) return (int)cudaErrorInvalidValue;
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
    const size_t total = (size_t)n * d;
    ce_bwd_tiled_dh_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                 st>>>((const float*)dh_part, (float*)dh,
                                       total, splits);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (dw == nullptr) return 0;
  ce_bwd_tiled_dw_kernel<T><<<dim3(vt, dt), kThreads, 0, st>>>(
      (const float*)p, (const T*)h, (float*)dw, (float*)db, n, d, v, np, vp);
  return (int)cudaGetLastError();
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
// split. Every split must own at least one vocab tile of 128 rows. Returns
// cudaGetLastError() after the launches (0 = success).
int deepsc_ce_bwd_tiled_f32(const void* h, const void* w, const void* b,
                            const void* labels, const void* lse,
                            const void* g, void* dh, void* dw, void* db,
                            void* p, void* dh_part, int n, int d, int v,
                            int splits, void* stream) {
  return launch<float>(h, w, b, labels, lse, g, dh, dw, db, p, dh_part, n,
                       d, v, splits, stream);
}

int deepsc_ce_bwd_tiled_bf16(const void* h, const void* w, const void* b,
                             const void* labels, const void* lse,
                             const void* g, void* dh, void* dw, void* db,
                             void* p, void* dh_part, int n, int d, int v,
                             int splits, void* stream) {
  return launch<__nv_bfloat16>(h, w, b, labels, lse, g, dh, dw, db, p,
                               dh_part, n, d, v, splits, stream);
}

}  // extern "C"
