// Fused multi-head attention backward (K2) in f32 at any head width and
// any number of heads, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_bwd_kernel` of
// deepsc_gan_tpu/ops/pallas/attention.py where the tuned kernel
// (csrc/attention_bwd.cu: a warp per head of a compile-time width 8, 16 or
// 32, at most 16 heads a block) does not take the shape: the JAX kernel
// takes any head width and count, so `--encoder-d-model 512` with 8 heads
// (Dh = 64), 4 heads of 64, 32 heads, or one head of 512 run here in f32,
// at any width (bf16 heads up to 256 wide take csrc/attention_wide_mma.cu,
// wider ones csrc/attention_chunked.cu, both on the tensor cores; the f32
// forward at these shapes is csrc/attention_tiled.cu's).
// Same function and order of roundings as the tuned kernels: with
// q (N, Lq, H*Dh), k and v (N, Lk, H*Dh), bias (N, Lq, Lk) f32 and g shaped
// like q,
//     s = (q_h . k_h) * (1/scale) + bias   (f32, two roundings)
//     p = exp(s - max) / sum               (f32)
//     dv = pc^T g with pc = p rounded to the input type, dp = g v^T,
//     ds = p (dp - rowsum(dp p)),
//     dq = dss k, dk = dss^T q with dss = (ds * (1/scale)) rounded to the
//     input type, dbias = sum_h ds (f32, heads in order 0..H-1).
//
// What bounds it: the chain of dependent warp reductions, not the card's
// memory (a simple kernel, right first). At N = 64, Lq = Lk = 31, 32 heads
// of 64 in f32 one call reads q, k, v, g and the bias and writes dq, dk,
// dv: about 114 MB (34 us at 3.35 TB/s); each (row, head, query) here runs
// three passes over the keys, each key a dot product of Dh elements summed
// across the warp by five shuffles.
//
// Design: a warp per (batch row, head, query) for dq, a warp per (batch
// row, head, key) for dk and dv, and a warp per (batch row, query) for
// dbias; eight warps a block, no shared memory.
// Lane l holds the elements d = l + 32 t of a head's slice, so a dot
// product is the lane's partial sum over its elements in the order of t
// and a butterfly of __shfl_xor_sync, which leaves every lane with the same
// bits. The softmax is exact, not online: a first pass over the keys takes
// the max, a second the sum of exponentials and sum_j e_j dp_j, and the
// last forms p = e / sum and accumulates; the logits are recomputed in
// each pass rather than kept. The dq kernel writes each query's (max, sum,
// rowsum) to the caller's statistics scratch (N, H, Lq, 4), read by the
// dk/dv kernel and the dbias kernel, which recompute s and dp with the
// same products in the same order (bitwise the dq kernel's).
// Every output element has one writer and a fixed order of sums: no
// atomics, the same bits on every call. The kernels allocate nothing.
//
// Heads up to 256 wide (kMaxDh) keep the lane's 8 elements of q (and g, k,
// v) in registers. A wider head takes the chunked kernels: the operands of
// each dot product are read from memory (the same elements in the same
// order, so the same bits as a register-held slice would give), and each
// output row is walked in chunks of 256 elements, 8 a lane: for each chunk
// the pass over the keys (or queries) is run again, its p (and ds)
// recomputed exactly as in the other passes, and the chunk's accumulators
// written before the next chunk starts. The work grows with the chunks (a
// head of 512 runs the accumulating pass twice) but registers do not, so
// any width runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxPer = 8;   // elements of a head a lane holds in registers
constexpr int kWarps = 8;    // warps a block
constexpr int kMaxDh = 32 * kMaxPer;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and read back (the plain version's `.to(dtype).float()`)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// the lane's elements d = lane + 32 t of a head's slice at `src`, 0 past dh
template <typename T>
__device__ __forceinline__ void load_slice(const T* __restrict__ src,
                                           int lane, int dh, float* dst) {
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int d = lane + 32 * t;
    dst[t] = d < dh ? to_f(src[d]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_slice(T* __restrict__ dst, int lane,
                                            int dh, const float* src) {
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int d = lane + 32 * t;
    if (d < dh) dst[d] = from_f<T>(src[t]);
  }
}

// sum over the head of a[d] * row[d]: the lane's partial sum over its
// elements in order, then a butterfly over the 32 lanes (every lane ends
// with the same bits: each step adds the same two values on both lanes of
// a pair)
template <typename T>
__device__ __forceinline__ float dot(const float* a,
                                     const T* __restrict__ row, int lane,
                                     int dh) {
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int d = lane + 32 * t;
    if (d < dh) acc = fmaf(a[t], to_f(row[d]), acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

__device__ __forceinline__ float logit(float qk, float inv_scale,
                                      float bias) {
  return __fadd_rn(__fmul_rn(qk, inv_scale), bias);
}

struct Shape {
  int n, lq, lk, heads, dh;
  float inv_scale;
};

// ---- backward ----

// dq and the statistics: a warp per (b, h, i)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ bias,
                             const T* __restrict__ g, T* __restrict__ dq,
                             float4* __restrict__ stats, Shape sh) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)sh.n * sh.heads * sh.lq) return;
  const int i = (int)(w % sh.lq);
  const long long nh = w / sh.lq;
  const int h = (int)(nh % sh.heads);
  const long long b = nh / sh.heads;
  const long long hd = (long long)sh.heads * sh.dh;
  const long long col = (long long)h * sh.dh;

  float qv[kMaxPer], gv[kMaxPer];
  const long long at = (b * sh.lq + i) * hd + col;
  load_slice(q + at, lane, sh.dh, qv);
  load_slice(g + at, lane, sh.dh, gv);
  const T* kb = k + b * sh.lk * hd + col;
  const T* vb = v + b * sh.lk * hd + col;
  const float* bb = bias + (b * sh.lq + i) * sh.lk;

  float m = -INFINITY;
  for (int j = 0; j < sh.lk; ++j)
    m = fmaxf(m, logit(dot(qv, kb + j * hd, lane, sh.dh), sh.inv_scale,
                       bb[j]));
  float l = 0.f, racc = 0.f;
  for (int j = 0; j < sh.lk; ++j) {
    const float e = expf(logit(dot(qv, kb + j * hd, lane, sh.dh),
                               sh.inv_scale, bb[j]) - m);
    l += e;
    racc = fmaf(e, dot(gv, vb + j * hd, lane, sh.dh), racc);
  }
  const float rowsum = __fdiv_rn(racc, l);
  float acc[kMaxPer];
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) acc[t] = 0.f;
  for (int j = 0; j < sh.lk; ++j) {
    const T* kj = kb + j * hd;
    const float s = logit(dot(qv, kj, lane, sh.dh), sh.inv_scale, bb[j]);
    const float dp = dot(gv, vb + j * hd, lane, sh.dh);
    const float p = __fdiv_rn(expf(s - m), l);
    const float ds = __fmul_rn(p, __fsub_rn(dp, rowsum));
    const float dss = round_to<T>(__fmul_rn(ds, sh.inv_scale));
#pragma unroll
    for (int t = 0; t < kMaxPer; ++t) {
      const int d = lane + 32 * t;
      if (d < sh.dh) acc[t] = fmaf(dss, to_f(kj[d]), acc[t]);
    }
  }
  store_slice(dq + at, lane, sh.dh, acc);
  if (lane == 0) stats[nh * sh.lq + i] = make_float4(m, l, rowsum, 0.f);
}

// dk and dv: a warp per (b, h, j), summing over the queries in order
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkv_wide_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ bias,
                              const T* __restrict__ g, T* __restrict__ dk,
                              T* __restrict__ dv,
                              const float4* __restrict__ stats, Shape sh) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)sh.n * sh.heads * sh.lk) return;
  const int j = (int)(w % sh.lk);
  const long long nh = w / sh.lk;
  const int h = (int)(nh % sh.heads);
  const long long b = nh / sh.heads;
  const long long hd = (long long)sh.heads * sh.dh;
  const long long col = (long long)h * sh.dh;

  float kv[kMaxPer], vv[kMaxPer];
  const long long at = (b * sh.lk + j) * hd + col;
  load_slice(k + at, lane, sh.dh, kv);
  load_slice(v + at, lane, sh.dh, vv);
  const T* qb = q + b * sh.lq * hd + col;
  const T* gb = g + b * sh.lq * hd + col;
  const float* bb = bias + b * sh.lq * sh.lk + j;
  const float4* st = stats + nh * sh.lq;

  float dka[kMaxPer], dva[kMaxPer];
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) dka[t] = dva[t] = 0.f;
  for (int i = 0; i < sh.lq; ++i) {
    const T* qi = qb + i * hd;
    const T* gi = gb + i * hd;
    const float4 sti = st[i];
    const float s = logit(dot(kv, qi, lane, sh.dh), sh.inv_scale,
                          bb[(long long)i * sh.lk]);
    const float dp = dot(vv, gi, lane, sh.dh);
    const float p = __fdiv_rn(expf(s - sti.x), sti.y);
    const float ds = __fmul_rn(p, __fsub_rn(dp, sti.z));
    const float dss = round_to<T>(__fmul_rn(ds, sh.inv_scale));
    const float pc = round_to<T>(p);
#pragma unroll
    for (int t = 0; t < kMaxPer; ++t) {
      const int d = lane + 32 * t;
      if (d < sh.dh) {
        dka[t] = fmaf(dss, to_f(qi[d]), dka[t]);
        dva[t] = fmaf(pc, to_f(gi[d]), dva[t]);
      }
    }
  }
  store_slice(dk + at, lane, sh.dh, dka);
  store_slice(dv + at, lane, sh.dh, dva);
}

// dbias = sum over heads 0..H-1 of ds: a warp per (b, i), lane 0 writing
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dbias_wide_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const float* __restrict__ bias,
                                const T* __restrict__ g,
                                float* __restrict__ dbias,
                                const float4* __restrict__ stats, Shape sh) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)sh.n * sh.lq) return;
  const int i = (int)(w % sh.lq);
  const long long b = w / sh.lq;
  const long long hd = (long long)sh.heads * sh.dh;
  const float* bb = bias + w * sh.lk;
  float* out = dbias + w * sh.lk;
  for (int j = 0; j < sh.lk; ++j) {
    float acc = 0.f;
    for (int h = 0; h < sh.heads; ++h) {
      const long long col = (long long)h * sh.dh;
      float qv[kMaxPer], gv[kMaxPer];
      load_slice(q + (b * sh.lq + i) * hd + col, lane, sh.dh, qv);
      load_slice(g + (b * sh.lq + i) * hd + col, lane, sh.dh, gv);
      const float4 sti = stats[(b * sh.heads + h) * sh.lq + i];
      const float s = logit(dot(qv, k + (b * sh.lk + j) * hd + col, lane,
                                sh.dh), sh.inv_scale, bb[j]);
      const float dp = dot(gv, v + (b * sh.lk + j) * hd + col, lane, sh.dh);
      const float p = __fdiv_rn(expf(s - sti.x), sti.y);
      acc = __fadd_rn(acc, __fmul_rn(p, __fsub_rn(dp, sti.z)));
    }
    if (lane == 0) out[j] = acc;
  }
}

// ---- heads wider than kMaxDh: the chunked kernels ----

// sum over the head of a[d] * b[d], both read from memory: the lane's
// elements d = lane + 32 t in the order of t, then the butterfly (the same
// products and order as `dot` on a register-held slice)
template <typename T>
__device__ __forceinline__ float dot_rows(const T* __restrict__ a,
                                          const T* __restrict__ b, int lane,
                                          int dh) {
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32)
    acc = fmaf(to_f(a[d]), to_f(b[d]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// acc[t] += w * row[c + lane + 32 t] over the chunk of the head at column c
template <typename T>
__device__ __forceinline__ void axpy_chunk(float w, const T* __restrict__ row,
                                           int c, int lane, int dh,
                                           float* acc) {
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int d = c + lane + 32 * t;
    if (d < dh) acc[t] = fmaf(w, to_f(row[d]), acc[t]);
  }
}

__device__ __forceinline__ void zero(float* acc) {
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) acc[t] = 0.f;
}

// dq and the statistics: a warp per (b, h, i)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_chunked_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const float* __restrict__ bias,
                                const T* __restrict__ g, T* __restrict__ dq,
                                float4* __restrict__ stats, Shape sh) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)sh.n * sh.heads * sh.lq) return;
  const int i = (int)(w % sh.lq);
  const long long nh = w / sh.lq;
  const int h = (int)(nh % sh.heads);
  const long long b = nh / sh.heads;
  const long long hd = (long long)sh.heads * sh.dh;
  const long long col = (long long)h * sh.dh;

  const long long at = (b * sh.lq + i) * hd + col;
  const T* qi = q + at;
  const T* gi = g + at;
  const T* kb = k + b * sh.lk * hd + col;
  const T* vb = v + b * sh.lk * hd + col;
  const float* bb = bias + (b * sh.lq + i) * sh.lk;

  float m = -INFINITY;
  for (int j = 0; j < sh.lk; ++j)
    m = fmaxf(m, logit(dot_rows(qi, kb + j * hd, lane, sh.dh), sh.inv_scale,
                       bb[j]));
  float l = 0.f, racc = 0.f;
  for (int j = 0; j < sh.lk; ++j) {
    const float e = expf(logit(dot_rows(qi, kb + j * hd, lane, sh.dh),
                               sh.inv_scale, bb[j]) - m);
    l += e;
    racc = fmaf(e, dot_rows(gi, vb + j * hd, lane, sh.dh), racc);
  }
  const float rowsum = __fdiv_rn(racc, l);
  for (int c = 0; c < sh.dh; c += kMaxDh) {
    float acc[kMaxPer];
    zero(acc);
    for (int j = 0; j < sh.lk; ++j) {
      const T* kj = kb + j * hd;
      const float s = logit(dot_rows(qi, kj, lane, sh.dh), sh.inv_scale,
                            bb[j]);
      const float dp = dot_rows(gi, vb + j * hd, lane, sh.dh);
      const float p = __fdiv_rn(expf(s - m), l);
      const float ds = __fmul_rn(p, __fsub_rn(dp, rowsum));
      const float dss = round_to<T>(__fmul_rn(ds, sh.inv_scale));
      axpy_chunk(dss, kj, c, lane, sh.dh, acc);
    }
    store_slice(dq + at + c, lane, sh.dh - c, acc);
  }
  if (lane == 0) stats[nh * sh.lq + i] = make_float4(m, l, rowsum, 0.f);
}

// dk and dv: a warp per (b, h, j), summing over the queries in order
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkv_chunked_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const float* __restrict__ bias,
                                 const T* __restrict__ g, T* __restrict__ dk,
                                 T* __restrict__ dv,
                                 const float4* __restrict__ stats, Shape sh) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)sh.n * sh.heads * sh.lk) return;
  const int j = (int)(w % sh.lk);
  const long long nh = w / sh.lk;
  const int h = (int)(nh % sh.heads);
  const long long b = nh / sh.heads;
  const long long hd = (long long)sh.heads * sh.dh;
  const long long col = (long long)h * sh.dh;

  const long long at = (b * sh.lk + j) * hd + col;
  const T* kj = k + at;
  const T* vj = v + at;
  const T* qb = q + b * sh.lq * hd + col;
  const T* gb = g + b * sh.lq * hd + col;
  const float* bb = bias + b * sh.lq * sh.lk + j;
  const float4* st = stats + nh * sh.lq;

  for (int c = 0; c < sh.dh; c += kMaxDh) {
    float dka[kMaxPer], dva[kMaxPer];
    zero(dka);
    zero(dva);
    for (int i = 0; i < sh.lq; ++i) {
      const T* qi = qb + i * hd;
      const T* gi = gb + i * hd;
      const float4 sti = st[i];
      const float s = logit(dot_rows(kj, qi, lane, sh.dh), sh.inv_scale,
                            bb[(long long)i * sh.lk]);
      const float dp = dot_rows(vj, gi, lane, sh.dh);
      const float p = __fdiv_rn(expf(s - sti.x), sti.y);
      const float ds = __fmul_rn(p, __fsub_rn(dp, sti.z));
      const float dss = round_to<T>(__fmul_rn(ds, sh.inv_scale));
      const float pc = round_to<T>(p);
      axpy_chunk(dss, qi, c, lane, sh.dh, dka);
      axpy_chunk(pc, gi, c, lane, sh.dh, dva);
    }
    store_slice(dk + at + c, lane, sh.dh - c, dka);
    store_slice(dv + at + c, lane, sh.dh - c, dva);
  }
}

// dbias = sum over heads 0..H-1 of ds: a warp per (b, i), lane 0 writing
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dbias_chunked_kernel(const T* __restrict__ q,
                                   const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   const float* __restrict__ bias,
                                   const T* __restrict__ g,
                                   float* __restrict__ dbias,
                                   const float4* __restrict__ stats,
                                   Shape sh) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)sh.n * sh.lq) return;
  const int i = (int)(w % sh.lq);
  const long long b = w / sh.lq;
  const long long hd = (long long)sh.heads * sh.dh;
  const float* bb = bias + w * sh.lk;
  float* out = dbias + w * sh.lk;
  for (int j = 0; j < sh.lk; ++j) {
    float acc = 0.f;
    for (int h = 0; h < sh.heads; ++h) {
      const long long col = (long long)h * sh.dh;
      const T* qi = q + (b * sh.lq + i) * hd + col;
      const T* gi = g + (b * sh.lq + i) * hd + col;
      const float4 sti = stats[(b * sh.heads + h) * sh.lq + i];
      const float s = logit(dot_rows(qi, k + (b * sh.lk + j) * hd + col,
                                     lane, sh.dh), sh.inv_scale, bb[j]);
      const float dp = dot_rows(gi, v + (b * sh.lk + j) * hd + col, lane,
                                sh.dh);
      const float p = __fdiv_rn(expf(s - sti.x), sti.y);
      acc = __fadd_rn(acc, __fmul_rn(p, __fsub_rn(dp, sti.z)));
    }
    if (lane == 0) out[j] = acc;
  }
}

unsigned blocks(long long warps) {
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

bool bad(const Shape& sh) {
  return sh.n <= 0 || sh.lq <= 0 || sh.lk <= 0 || sh.heads <= 0 ||
         sh.dh <= 0;
}

Shape shape(int n, int lq, int lk, int heads, int dh, double scale) {
  // 1/scale in double, rounded once to f32, as the tuned kernels
  return Shape{n, lq, lk, heads, dh, (float)(1.0 / scale)};
}

// f32 (the bf16 backward is csrc/attention_wide_mma.cu's up to 256-wide
// heads, csrc/attention_chunked.cu's past them)
int launch_bwd(const void* q, const void* k, const void* v, const void* bias,
               const void* g, void* dq, void* dk, void* dv, void* dbias,
               void* stats, const Shape& sh, void* stream) {
  using T = float;
  const bool chunked = sh.dh > kMaxDh;
  if (bad(sh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned q_grid = blocks((long long)sh.n * sh.heads * sh.lq);
  const unsigned k_grid = blocks((long long)sh.n * sh.heads * sh.lk);
  const unsigned b_grid = blocks((long long)sh.n * sh.lq);
  if (chunked)
    attention_bwd_dq_chunked_kernel<T><<<q_grid, kWarps * 32, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (T*)dq, (float4*)stats, sh);
  else
    attention_bwd_dq_wide_kernel<T><<<q_grid, kWarps * 32, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (T*)dq, (float4*)stats, sh);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (chunked)
    attention_bwd_dkv_chunked_kernel<T><<<k_grid, kWarps * 32, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (T*)dk, (T*)dv, (const float4*)stats, sh);
  else
    attention_bwd_dkv_wide_kernel<T><<<k_grid, kWarps * 32, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (T*)dk, (T*)dv, (const float4*)stats, sh);
  err = (int)cudaGetLastError();
  if (err || dbias == nullptr) return err;
  if (chunked)
    attention_bwd_dbias_chunked_kernel<T><<<b_grid, kWarps * 32, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (float*)dbias, (const float4*)stats, sh);
  else
    attention_bwd_dbias_wide_kernel<T><<<b_grid, kWarps * 32, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (float*)dbias, (const float4*)stats, sh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, g, dq: contiguous f32 (N, Lq, heads*dh); k, v, dk, dv: (N, Lk,
// heads*dh); bias: contiguous f32 (N, Lq, Lk); dbias f32 (N, Lq, Lk) or
// null; `stats` the caller's f32 scratch (N, heads, Lq, 4), 16-byte
// aligned; any N, Lq, Lk, heads and dh >= 1 (past 256 the chunked
// kernels). Returns cudaGetLastError() after the launches (0 = success).
int deepsc_attention_wide_bwd_f32(const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* g, void* dq, void* dk, void* dv,
                                  void* dbias, void* stats, int n, int lq,
                                  int lk, int heads, int dh, double scale,
                                  void* stream) {
  return launch_bwd(q, k, v, bias, g, dq, dk, dv, dbias, stats,
                    shape(n, lq, lk, heads, dh, scale), stream);
}

}  // extern "C"
