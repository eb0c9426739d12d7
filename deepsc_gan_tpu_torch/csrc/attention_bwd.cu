// Fused multi-head attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_bwd_kernel` of deepsc_gan_tpu/ops/pallas/
// attention.py (the custom VJP of `fused_attention`); the forward is
// csrc/attention_fwd.cu. For each batch row n and head h, with q (N, Lq,
// H*Dh), k and v (N, Lk, H*Dh), bias (N, Lq, Lk) f32 and the output's
// cotangent g shaped like q, it recomputes the forward's probabilities and
// returns
//     dv = pc^T g,  dp = g v^T (f32),  ds = p * (dp - rowsum(dp * p)),
//     dq = dss k,   dk = dss^T q,      dbias = sum_h ds (f32, unscaled),
// in the TPU kernel's order of roundings: p is recomputed exactly as the
// forward computes it (f32 logits `s * (1/scale)` then `+ bias`, two
// roundings, no fused multiply-add across them); pc = p rounded to the
// input type feeds dv only; ds uses the f32 p; dss = (ds * (1/scale))
// rounded to the input type feeds dq and dk. dq, dk, dv are summed in f32
// and rounded to the input type; dbias stays f32. A null dbias pointer skips
// its reduction and write (the mask bias of the training path needs no
// gradient).
//
// What bounds it: memory. At the training path's decoder self-attention
// (N = 64, Lq = Lk = 31, H = 8, Dh = 16, bf16) one call reads q, k, v, g
// (2 MB) and the bias (0.25 MB) and writes dq, dk, dv (1.5 MB): under 4 MB,
// about 1 us at 3.35 TB/s, against 4 products of 64 x 8 x 31 x 31 x 16
// multiply-adds (0.06 GFLOP). At so few bytes the launch and the
// per-row latency of the four dependent phases set the time.
//
// Design: one block per batch row for all heads (a warp per head), the
// row's q, g, k, v (as f32), its bias tile and, for every head, p and ds
// (Lq x (Lk | 1) f32 each: odd row strides, so a warp's accesses fall in
// distinct banks) kept in shared memory. Phase 1, a thread per (query,
// head) (lane = query): the logits, p, dp, the row sum and ds, written to
// shared memory, and dq. Phase 2, a thread per (key, head) (lane = key):
// dk and dv, summing over queries. Phase 3, a thread per (query, key):
// dbias, summing over heads 0..H-1. Every sum runs in a fixed order and no
// atomics are used, so a step is deterministic. Making it fast (wgmma,
// folding the head split into the projections, several rows per block) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kMaxKeys = 32;   // keys per row (lk <= 32)
constexpr int kMaxLen = 32;    // queries per row (lq <= 32)
constexpr int kMaxHeads = 16;  // one warp per head: <= 512 threads

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the TPU kernel's `.astype(dtype)` before a
// product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// 16-byte moves (the wrapper requires 16-byte aligned tensors; a head's
// slice, Dh * sizeof(T) bytes, is a multiple of 16)
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int t = 0; t < 16 / (int)sizeof(T); ++t) dst[t] = to_float(e[t]);
}

template <typename T>
__device__ __forceinline__ void store16(T* dst, const float* src) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int t = 0; t < 16 / (int)sizeof(T); ++t) e[t] = from_float<T>(src[t]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// rows x hd elements of a row-major (rows, hd) T array -> f32 shared memory
template <typename T>
__device__ __forceinline__ void stage(const T* src, float* dst, int count) {
  constexpr int kPer16 = 16 / (int)sizeof(T);
  float tmp[kPer16];
  for (int e = threadIdx.x * kPer16; e < count; e += blockDim.x * kPer16) {
    load16(src + e, tmp);
#pragma unroll
    for (int t = 0; t < kPer16; t += 4)
      *reinterpret_cast<float4*>(dst + e + t) =
          make_float4(tmp[t], tmp[t + 1], tmp[t + 2], tmp[t + 3]);
  }
}

// Shared memory (f32): qs, gs (Lq x H*Dh); ks, vs (Lk x H*Dh); bs
// (Lq x (Lk | 1)); ps, dss (H x Lq x (Lk | 1)): p and the unscaled ds.
template <typename T, int DH>
__global__ void __launch_bounds__(kMaxHeads * 32)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ g, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dbias, int lq, int lk, int heads,
                     float inv_scale) {
  extern __shared__ float smem[];
  const int hd = heads * DH;
  const int bstride = lk | 1;
  float* qs = smem;
  float* gs = qs + lq * hd;
  float* ks = gs + lq * hd;
  float* vs = ks + lk * hd;
  float* bs = vs + lk * hd;
  float* ps = bs + lq * bstride;
  float* dss = ps + heads * lq * bstride;

  const long long n = blockIdx.x;
  const T* qn = q + n * lq * hd;
  const T* gn = g + n * lq * hd;
  stage(qn, qs, lq * hd);
  stage(gn, gs, lq * hd);
  stage(k + n * lk * hd, ks, lk * hd);
  stage(v + n * lk * hd, vs, lk * hd);
  const float* bn = bias + n * lq * lk;
  for (int e = threadIdx.x; e < lq * lk; e += blockDim.x) {
    const int i = e / lk;
    bs[i * bstride + (e - i * lk)] = bn[e];
  }
  __syncthreads();

  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int kPer16 = 16 / (int)sizeof(T);

  // ---- phase 1: thread (query i = lane, head h)
  if (lane < lq) {
    const int i = lane;
    // this thread's query and cotangent rows, read from device memory into
    // registers (a warp reading them from shared memory would hit one bank)
    float qv[DH];
    float gv[DH];
#pragma unroll
    for (int d = 0; d < DH; d += kPer16) {
      load16(qn + i * hd + h * DH + d, qv + d);
      load16(gn + i * hd + h * DH + d, gv + d);
    }
    // the forward's logits and probabilities, as csrc/attention_fwd.cu
    float s[kMaxKeys];
    float m = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
      if (j < lk) {
        const float* kj = ks + j * hd + h * DH;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc = fmaf(qv[d], kj[d], acc);
        s[j] = __fadd_rn(__fmul_rn(acc, inv_scale), bs[i * bstride + j]);
        m = fmaxf(m, s[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
      if (j < lk) {
        s[j] = expf(s[j] - m);
        sum += s[j];
      }
    }
    // p_j (f32), dp_j = g_i . v_j (f32) and rowsum(dp * p)
    float dp[kMaxKeys];
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
      if (j < lk) {
        s[j] = __fdiv_rn(s[j], sum);
        const float* vj = vs + j * hd + h * DH;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc = fmaf(gv[d], vj[d], acc);
        dp[j] = acc;
        rowsum = __fadd_rn(rowsum, __fmul_rn(acc, s[j]));
      }
    }
    // ds_j = p_j (dp_j - rowsum); dq = sum_j dss_j k_j
    float* p_row = ps + (h * lq + i) * bstride;
    float* ds_row = dss + (h * lq + i) * bstride;
    float dqa[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dqa[d] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
      if (j < lk) {
        const float ds = __fmul_rn(s[j], __fsub_rn(dp[j], rowsum));
        p_row[j] = s[j];
        ds_row[j] = ds;
        const float dsc = round_to<T>(__fmul_rn(ds, inv_scale));
        const float* kj = ks + j * hd + h * DH;
#pragma unroll
        for (int d = 0; d < DH; ++d) dqa[d] = fmaf(dsc, kj[d], dqa[d]);
      }
    }
    T* dqi = dq + (n * lq + i) * hd + h * DH;
#pragma unroll
    for (int d = 0; d < DH; d += kPer16) store16(dqi + d, dqa + d);
  }
  __syncthreads();

  // ---- phase 2: thread (key j = lane, head h): dk and dv over queries
  if (lane < lk) {
    const int j = lane;
    float dka[DH];
    float dva[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dka[d] = 0.f;
      dva[d] = 0.f;
    }
    for (int i = 0; i < lq; ++i) {
      const float pc = round_to<T>(ps[(h * lq + i) * bstride + j]);
      const float dsc =
          round_to<T>(__fmul_rn(dss[(h * lq + i) * bstride + j], inv_scale));
      const float* qi = qs + i * hd + h * DH;
      const float* gi = gs + i * hd + h * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dka[d] = fmaf(dsc, qi[d], dka[d]);
        dva[d] = fmaf(pc, gi[d], dva[d]);
      }
    }
    T* dkj = dk + (n * lk + j) * hd + h * DH;
    T* dvj = dv + (n * lk + j) * hd + h * DH;
#pragma unroll
    for (int d = 0; d < DH; d += kPer16) {
      store16(dkj + d, dka + d);
      store16(dvj + d, dva + d);
    }
  }

  // ---- phase 3: thread (query, key): dbias = sum over heads 0..H-1
  if (dbias != nullptr) {
    float* dbn = dbias + n * lq * lk;
    for (int e = threadIdx.x; e < lq * lk; e += blockDim.x) {
      const int i = e / lk;
      const int j = e - i * lk;
      float acc = 0.f;
      for (int hh = 0; hh < heads; ++hh)
        acc = __fadd_rn(acc, dss[(hh * lq + i) * bstride + j]);
      dbn[e] = acc;
    }
  }
}

size_t smem_bytes(int lq, int lk, int heads, int dh) {
  const size_t hd = (size_t)heads * dh;
  const size_t tile = (size_t)lq * (size_t)(lk | 1);
  return sizeof(float) *
         (2 * (size_t)lq * hd + 2 * (size_t)lk * hd + tile +
          2 * (size_t)heads * tile);
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* bias,
              const void* g, void* dq, void* dk, void* dv, void* dbias,
              int n, int lq, int lk, int heads, float inv_scale,
              void* stream) {
  const size_t smem = smem_bytes(lq, lk, heads, DH);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  attention_bwd_kernel<T, DH><<<n, heads * 32, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
      (const T*)g, (T*)dq, (T*)dk, (T*)dv, (float*)dbias, lq, lk, heads,
      inv_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* g, void* dq, void* dk, void* dv, void* dbias, int n,
           int lq, int lk, int heads, int dh, double scale, void* stream) {
  if (n <= 0 || lq <= 0 || lq > kMaxLen || lk <= 0 || lk > kMaxKeys ||
      heads <= 0 || heads > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  // 1/scale in double, rounded once to f32, as the forward
  const float inv_scale = (float)(1.0 / scale);
  switch (dh) {
    case 8:
      return launch_dh<T, 8>(q, k, v, bias, g, dq, dk, dv, dbias, n, lq, lk,
                             heads, inv_scale, stream);
    case 16:
      return launch_dh<T, 16>(q, k, v, bias, g, dq, dk, dv, dbias, n, lq, lk,
                              heads, inv_scale, stream);
    case 32:
      return launch_dh<T, 32>(q, k, v, bias, g, dq, dk, dv, dbias, n, lq, lk,
                              heads, inv_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the wrapper checks this
// against the device's limit before launching).
size_t deepsc_attention_bwd_smem_bytes(int lq, int lk, int heads, int dh) {
  return smem_bytes(lq, lk, heads, dh);
}

// q, g, dq: contiguous f32 (N, Lq, heads*dh); k, v, dk, dv: (N, Lk,
// heads*dh); bias: contiguous f32 (N, Lq, Lk); dbias: f32 (N, Lq, Lk) or
// null. Returns cudaGetLastError() after the launch (0 = success).
int deepsc_attention_bwd_f32(const void* q, const void* k, const void* v,
                             const void* bias, const void* g, void* dq,
                             void* dk, void* dv, void* dbias, int n, int lq,
                             int lk, int heads, int dh, double scale,
                             void* stream) {
  return launch<float>(q, k, v, bias, g, dq, dk, dv, dbias, n, lq, lk, heads,
                       dh, scale, stream);
}

// As above with q, k, v, g, dq, dk, dv in bf16 (bias and dbias f32).
int deepsc_attention_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* bias, const void* g, void* dq,
                              void* dk, void* dv, void* dbias, int n, int lq,
                              int lk, int heads, int dh, double scale,
                              void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, g, dq, dk, dv, dbias, n, lq,
                               lk, heads, dh, scale, stream);
}

}  // extern "C"
