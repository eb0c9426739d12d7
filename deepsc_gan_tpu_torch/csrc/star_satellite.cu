// Star-Transformer satellite update for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_satellite_kernel` of deepsc_gan_tpu/ops/pallas/
// star.py (reached through `star_satellite_attention`). For each row n of
// q (N, D) and each head h it computes
//     s_j = (q_h . k_{j,h}) / sqrt(Dh)        for the 5 contexts j
//     out[n, h*Dh:(h+1)*Dh] = sum_j softmax_j(s)_j v_{j,h}
// with k and v (5, N, D) stacked by the caller (the contexts {h_{i+1}, h_i,
// h_{i-1}, e_i, s}) and out shaped like q. As in the TPU kernel: scores,
// softmax and the weighted sum in f32, one rounding to the output type.
//
// What bounds it: memory. Each row reads q and the 10 context vectors and
// writes one output, 12 x D elements, and does about 20 x D flops. At the
// star sweep's decoder (N = 19 SNRs x 64 x 31 = 37,696, D = 128, bf16) one
// call moves 116 MB, 35 us at the H100 SXM's 3.35 TB/s, against 0.1 GFLOP.
// Computed from the shapes.
//
// Design: the TPU kernel keeps D on the 128 lanes and does the head sums as
// an MXU product with a block-diagonal (D, H) matrix; Hopper needs neither.
// One warp per row, 8 rows per block; each lane holds E = D / 32
// consecutive elements of q and of each of the 10 context vectors, read
// with one vector load each (all 11 loads in flight before any use). The
// per-head dot product is a per-lane partial sum and a butterfly of
// __shfl_xor_sync over the Dh / E lanes of the head (4 lanes at D = 128,
// Dh = 16). The 5-way softmax and the weighted sum stay in f32 registers;
// each lane stores its E outputs with one vector store. Nothing is shared
// between warps, so a ragged last block simply has idle warps. The kernel
// allocates nothing; the caller passes the output. Reading the unstacked
// k/v of h, e and s and rolling by index (which would save the caller's
// stack copies) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kContexts = 5;
constexpr int kRowsPerBlock = 8;  // one warp per row

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

// A lane's E elements move as chunks of at most 16 bytes (E * sizeof(T) is
// 4 to 32 bytes). Every chunk is aligned to its size: the wrapper requires
// 16-byte aligned tensors, a row is D * sizeof(T) >= 128 bytes, and a
// lane's slice starts at a multiple of E * sizeof(T).
template <int BYTES>
struct Chunk;
template <>
struct Chunk<4> { using type = unsigned int; };
template <>
struct Chunk<8> { using type = uint2; };
template <>
struct Chunk<16> { using type = uint4; };

template <typename T, int E>
struct LaneVec {
  static constexpr int kBytes = E * (int)sizeof(T);
  static constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  static constexpr int kPer = kChunk / (int)sizeof(T);
  using V = typename Chunk<kChunk>::type;

  static __device__ __forceinline__ void load(const T* src, float* dst) {
#pragma unroll
    for (int c = 0; c < kBytes / kChunk; ++c) {
      const V u = __ldg(reinterpret_cast<const V*>(src) + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int t = 0; t < kPer; ++t) dst[c * kPer + t] = to_float(e[t]);
    }
  }

  static __device__ __forceinline__ void store(T* dst, const float* src) {
#pragma unroll
    for (int c = 0; c < kBytes / kChunk; ++c) {
      V u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int t = 0; t < kPer; ++t) e[t] = from_float<T>(src[c * kPer + t]);
      reinterpret_cast<V*>(dst)[c] = u;
    }
  }
};

template <typename T, int E>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
star_satellite_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int n,
                      int lanes_per_head, float sqrt_dh) {
  constexpr int D = 32 * E;
  using Vec = LaneVec<T, E>;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp: no shuffle spans a missing row

  const size_t off = (size_t)row * D + (size_t)lane * E;
  const size_t ctx = (size_t)n * D;  // stride between contexts
  float qv[E], kv[kContexts][E], vv[kContexts][E];
  Vec::load(q + off, qv);
#pragma unroll
  for (int j = 0; j < kContexts; ++j) Vec::load(k + j * ctx + off, kv[j]);
#pragma unroll
  for (int j = 0; j < kContexts; ++j) Vec::load(v + j * ctx + off, vv[j]);

  // per-head scores: the lane's partial dot, summed over the head's lanes
  // (an aligned group of lanes_per_head, a power of two)
  float s[kContexts];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kContexts; ++j) {
    float p = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) p = fmaf(qv[e], kv[j][e], p);
    for (int o = 1; o < lanes_per_head; o <<= 1)
      p += __shfl_xor_sync(0xffffffffu, p, o);
    s[j] = __fdiv_rn(p, sqrt_dh);
    m = fmaxf(m, s[j]);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kContexts; ++j) {
    s[j] = expf(s[j] - m);
    sum += s[j];
  }
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
  for (int j = 0; j < kContexts; ++j) {
    const float w = __fdiv_rn(s[j], sum);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(w, vv[j][e], acc[e]);
  }
  Vec::store(out + off, acc);
}

template <typename T, int E>
int launch_e(const void* q, const void* k, const void* v, void* out, int n,
             int dh, void* stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  star_satellite_kernel<T, E>
      <<<blocks, kRowsPerBlock * 32, 0, (cudaStream_t)stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)out, n, dh / E,
          (float)sqrt((double)dh));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int n,
           int d, int heads, void* stream) {
  if (n <= 0 || heads <= 0 || d % heads) return (int)cudaErrorInvalidValue;
  const int dh = d / heads;
  // a head spans a power of two of lanes, each holding d / 32 elements
  if (dh < d / 32 || (dh & (dh - 1))) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return launch_e<T, 2>(q, k, v, out, n, dh, stream);
    case 128:
      return launch_e<T, 4>(q, k, v, out, n, dh, stream);
    case 256:
      return launch_e<T, 8>(q, k, v, out, n, dh, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out: contiguous f32 (N, D); k, v: contiguous f32 (5, N, D); D in
// {64, 128, 256}, D / heads a power of two >= D / 32. Returns
// cudaGetLastError() after the launch (0 = success).
int deepsc_star_satellite_f32(const void* q, const void* k, const void* v,
                              void* out, int n, int d, int heads,
                              void* stream) {
  return launch<float>(q, k, v, out, n, d, heads, stream);
}

// As above with q, k, v, out in bf16.
int deepsc_star_satellite_bf16(const void* q, const void* k, const void* v,
                               void* out, int n, int d, int heads,
                               void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, n, d, heads, stream);
}

}  // extern "C"
