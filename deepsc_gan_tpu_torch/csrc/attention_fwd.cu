// Fused multi-head attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` of deepsc_gan_tpu/ops/pallas/
// attention.py (reached through `fused_attention`). Per batch row n and
// head h it computes
//     out[n, :, h*Dh:(h+1)*Dh] = softmax(q_h k_h^T * (1/scale) + bias[n]) v_h
// with q (N, Lq, H*Dh), k and v (N, Lk, H*Dh), bias (N, Lq, Lk) f32 (the
// additive -1e9 mask, shared by the heads) and out shaped like q. As in the
// TPU kernel: logits and softmax in f32; the probabilities rounded to the
// input type before the p.v product; the context summed in f32 and rounded
// to the output type. The bias is added as given: no -inf, no skipped keys,
// so a row whose keys are all blocked gives the same near-uniform weights
// as the TPU kernel.
//
// What bounds it: memory. At the decoder's self-attention on the serving
// path (N = 19 SNRs x 64 = 1,216, Lq = Lk = 31, H = 8, Dh = 16, bf16) one
// call reads q, k, v (29 MB) and the f32 bias (4.7 MB) and writes out
// (9.7 MB): about 43 MB, 13 us at the H100 SXM's 3.35 TB/s, against about
// 0.3 GFLOP (0.3 us at the bf16 tensor-core rate). Computed from the shapes.
//
// Design: one block per batch row, for all heads; one thread per
// (query, head) pair, a warp per head (lane = query), so every read of the
// row's keys and values is a broadcast. The row's K and V (as f32) and its
// bias tile (rows of an odd number of words, so a warp's per-query reads
// fall in distinct banks) are staged in shared memory once: each byte of
// k, v and bias is read from device memory once. Each thread keeps its
// query, its Lk logits and its context in registers (Dh and the largest Lk
// are compile-time: Dh in {8, 16, 32}, Lk <= 32). Every sum runs in a
// fixed order: the dot over d, the softmax denominator and the context
// over keys. The kernel allocates nothing; the caller passes the output.
// Making it fast (wgmma, TMA, folding the head split into the projections)
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kMaxKeys = 32;   // keys per row (lk <= 32)
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

// 16-byte moves: a thread's query, its context and the staged rows move
// as uint4 (the wrapper requires 16-byte aligned tensors; a head's slice,
// Dh * sizeof(T) bytes, is a multiple of 16).
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

// Shared memory: ks, vs (Lk x H*Dh f32 each), bs (Lq x (Lk | 1) f32).
template <typename T, int DH>
__global__ void __launch_bounds__(kMaxHeads * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, int lq, int lk, int heads,
                     float inv_scale) {
  extern __shared__ float smem[];
  const int hd = heads * DH;
  const int bstride = lk | 1;
  float* ks = smem;
  float* vs = ks + lk * hd;
  float* bs = vs + lk * hd;

  const long long n = blockIdx.x;
  const T* kn = k + n * lk * hd;
  const T* vn = v + n * lk * hd;
  const float* bn = bias + n * lq * lk;
  constexpr int kPer16 = 16 / (int)sizeof(T);
  float tmp[kPer16];
  for (int e = threadIdx.x * kPer16; e < lk * hd; e += blockDim.x * kPer16) {
    load16(kn + e, tmp);
#pragma unroll
    for (int t = 0; t < kPer16; t += 4)
      *reinterpret_cast<float4*>(ks + e + t) =
          make_float4(tmp[t], tmp[t + 1], tmp[t + 2], tmp[t + 3]);
    load16(vn + e, tmp);
#pragma unroll
    for (int t = 0; t < kPer16; t += 4)
      *reinterpret_cast<float4*>(vs + e + t) =
          make_float4(tmp[t], tmp[t + 1], tmp[t + 2], tmp[t + 3]);
  }
  for (int e = threadIdx.x; e < lq * lk; e += blockDim.x) {
    const int i = e / lk;
    bs[i * bstride + (e - i * lk)] = bn[e];
  }
  __syncthreads();

  const int h = threadIdx.x >> 5;
  const int i = threadIdx.x & 31;
  if (i >= lq) return;  // no later barrier
  const T* qi = q + (n * lq + i) * hd + h * DH;
  float qv[DH];
#pragma unroll
  for (int d = 0; d < DH; d += kPer16) load16(qi + d, qv + d);

  // logits: s_j = (q . k_j) * (1/scale) + bias[i, j], rounded twice as the
  // TPU kernel does (no fused multiply-add across the two steps)
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
  // p_j = e_j / sum, rounded to the input type before the p.v product
  float ctx[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) ctx[d] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxKeys; ++j) {
    if (j < lk) {
      const float p = to_float(from_float<T>(__fdiv_rn(s[j], sum)));
      const float* vj = vs + j * hd + h * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) ctx[d] = fmaf(p, vj[d], ctx[d]);
    }
  }
  T* oi = out + (n * lq + i) * hd + h * DH;
#pragma unroll
  for (int d = 0; d < DH; d += kPer16) store16(oi + d, ctx + d);
}

size_t smem_bytes(int lq, int lk, int heads, int dh) {
  return sizeof(float) *
         (2 * (size_t)lk * heads * dh + (size_t)lq * (size_t)(lk | 1));
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* bias,
              void* out, int n, int lq, int lk, int heads, float inv_scale,
              void* stream) {
  const size_t smem = smem_bytes(lq, lk, heads, DH);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  attention_fwd_kernel<T, DH><<<n, heads * 32, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out, lq,
      lk, heads, inv_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int n, int lq, int lk, int heads, int dh, double scale,
           void* stream) {
  if (n <= 0 || lq <= 0 || lq > 32 || lk <= 0 || lk > kMaxKeys ||
      heads <= 0 || heads > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  // 1/scale in double, then rounded once to f32: the TPU kernel's
  // `s * (1.0 / scale)` with a Python-float scale
  const float inv_scale = (float)(1.0 / scale);
  switch (dh) {
    case 8:
      return launch_dh<T, 8>(q, k, v, bias, out, n, lq, lk, heads, inv_scale,
                             stream);
    case 16:
      return launch_dh<T, 16>(q, k, v, bias, out, n, lq, lk, heads,
                              inv_scale, stream);
    case 32:
      return launch_dh<T, 32>(q, k, v, bias, out, n, lq, lk, heads,
                              inv_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the wrapper checks this
// against the device's limit before launching).
size_t deepsc_attention_fwd_smem_bytes(int lq, int lk, int heads, int dh) {
  return smem_bytes(lq, lk, heads, dh);
}

// q, k, v, out: contiguous f32 (N, L, heads*dh); bias: contiguous f32
// (N, Lq, Lk). Returns cudaGetLastError() after the launch (0 = success).
int deepsc_attention_fwd_f32(const void* q, const void* k, const void* v,
                             const void* bias, void* out, int n, int lq,
                             int lk, int heads, int dh, double scale,
                             void* stream) {
  return launch<float>(q, k, v, bias, out, n, lq, lk, heads, dh, scale,
                       stream);
}

// As above with q, k, v, out in bf16.
int deepsc_attention_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* bias, void* out, int n, int lq,
                              int lk, int heads, int dh, double scale,
                              void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, out, n, lq, lk, heads, dh,
                               scale, stream);
}

}  // extern "C"
