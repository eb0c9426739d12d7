// Star-Transformer satellite update at any width D and any number of heads
// that divides it, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_satellite_kernel` of deepsc_gan_tpu/ops/pallas/
// star.py where the tuned kernel (csrc/star_satellite.cu: a warp per row,
// each lane holding D / 32 consecutive elements, so D in {64, 128, 256} and
// a head spanning a power of two of lanes) does not take the width: the JAX
// kernel takes any D and head count the star model takes, so
// `--encoder-d-model 96` or 512 runs here. Same function and roundings as
// the tuned kernel: row (b, i) attends over its five contexts {h_{i+1},
// h_i, h_{i-1}, e_i, s} (neighbours circular over L), per head
//     s_j = (q_h . k_{j,h}) / sqrt(Dh),  w = softmax_j(s),
//     out_h = sum_j w_j v_{j,h}
// in f32 (the max and sum over the five in that order), rounded once to the
// output type, reading the ring unstacked: q, kh, vh, ke, ve (B, L, D) and
// ks, vs (B, D).
//
// What bounds it: memory, as the tuned kernel's (6 N D + 2 B D elements a
// call); here each element is a 2- or 4-byte load of its own, not a
// 16-byte vector (a simple kernel, right first).
//
// Design: a warp per (row, head), eight warps a block, no shared memory:
// the five scores are dot products over the head's Dh elements, lane l
// taking d = l, l + 32, ... and a butterfly of __shfl_xor_sync summing
// them (every lane ends with the same bits), then the softmax in registers
// and the weighted sum written element by element by the same lanes. Any
// Dh, any number of heads. The kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kContexts = 5;
constexpr int kWarps = 8;

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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
star_wide_kernel(const T* __restrict__ q, const T* __restrict__ kh,
                 const T* __restrict__ vh, const T* __restrict__ ke,
                 const T* __restrict__ ve, const T* __restrict__ ks,
                 const T* __restrict__ vs, T* __restrict__ out, long long n,
                 int len, int d, int heads, float sqrt_dh) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= n * heads) return;  // the whole warp
  const long long row = w / heads;
  const int dh = d / heads;
  const long long col = (long long)(w - row * heads) * dh;
  const long long b = row / len;
  const long long i = row - b * len;
  const long long nxt = b * len + (i + 1 == len ? 0 : i + 1);
  const long long prv = b * len + (i == 0 ? len - 1 : i - 1);
  // contexts in the TPU kernel's order: h_{i+1}, h_i, h_{i-1}, e_i, s
  const T* kp[kContexts] = {kh + nxt * d + col, kh + row * d + col,
                            kh + prv * d + col, ke + row * d + col,
                            ks + b * d + col};
  const T* vp[kContexts] = {vh + nxt * d + col, vh + row * d + col,
                            vh + prv * d + col, ve + row * d + col,
                            vs + b * d + col};
  const T* qr = q + row * d + col;

  float s[kContexts];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kContexts; ++j) {
    float p = 0.f;
    for (int e = lane; e < dh; e += 32)
      p = fmaf(to_f(qr[e]), to_f(kp[j][e]), p);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    s[j] = __fdiv_rn(p, sqrt_dh);
    m = fmaxf(m, s[j]);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kContexts; ++j) {
    s[j] = expf(s[j] - m);
    sum += s[j];
  }
#pragma unroll
  for (int j = 0; j < kContexts; ++j) s[j] = __fdiv_rn(s[j], sum);
  T* o = out + row * d + col;
  for (int e = lane; e < dh; e += 32) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kContexts; ++j)
      acc = fmaf(s[j], to_f(vp[j][e]), acc);
    o[e] = from_f<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* kh, const void* vh, const void* ke,
           const void* ve, const void* ks, const void* vs, void* out, int b,
           int len, int d, int heads, void* stream) {
  if (b <= 0 || len <= 0 || d <= 0 || heads <= 0 || d % heads)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)b * len;
  const long long warps = n * heads;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > (1ll << 31) - 1) return (int)cudaErrorInvalidValue;
  star_wide_kernel<T><<<(unsigned)blocks, kWarps * 32, 0,
                        (cudaStream_t)stream>>>(
      (const T*)q, (const T*)kh, (const T*)vh, (const T*)ke, (const T*)ve,
      (const T*)ks, (const T*)vs, (T*)out, n, len, d, heads,
      (float)sqrt((double)(d / heads)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, kh, vh, ke, ve, out: contiguous (B, L, D); ks, vs: contiguous (B, D);
// any D >= 1 and heads dividing it. Returns cudaGetLastError() after the
// launch (0 = success).
int deepsc_star_wide_f32(const void* q, const void* kh, const void* vh,
                         const void* ke, const void* ve, const void* ks,
                         const void* vs, void* out, int b, int len, int d,
                         int heads, void* stream) {
  return launch<float>(q, kh, vh, ke, ve, ks, vs, out, b, len, d, heads,
                       stream);
}

int deepsc_star_wide_bf16(const void* q, const void* kh, const void* vh,
                          const void* ke, const void* ve, const void* ks,
                          const void* vs, void* out, int b, int len, int d,
                          int heads, void* stream) {
  return launch<__nv_bfloat16>(q, kh, vh, ke, ve, ks, vs, out, b, len, d,
                               heads, stream);
}

}  // extern "C"
