// Star-Transformer satellite update for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_satellite_kernel` of deepsc_gan_tpu/ops/pallas/
// star.py (reached through `star_satellite_attention`). The caller
// (models/star.py `StarAttention.satellite`) projects the ring once: q, kh,
// vh from the satellites h, ke, ve from the embeddings e, each (B, L, D),
// and ks, vs from the relay s, each (B, D). Row (b, i) attends over its five
// contexts in the TPU kernel's order {h_{i+1}, h_i, h_{i-1}, e_i, s}, the
// neighbours taken circularly over the padded length L as `jnp.roll` takes
// them (at L = 1 and 2 they coincide):
//     k_j = kh[b, (i+1) % L], kh[b, i], kh[b, (i-1) % L], ke[b, i], ks[b]
//     s_j = (q_h . k_{j,h}) / sqrt(Dh)  for each head h
//     out[b, i, h*Dh:(h+1)*Dh] = sum_j softmax_j(s)_j v_{j,h}
// with v_j likewise, out shaped like q: exactly the TPU kernel's function
// on the stacked contexts that the JAX model builds (roll, stack,
// broadcast), without building them. As in the TPU kernel: scores, the
// softmax (max and sum over the five in that order) and the weighted sum
// in f32, one rounding to the output type.
//
// What bounds it: memory. A row reads q, kh, vh, ke, ve and writes its
// output, 6 x D elements, and ks, vs once per sequence (2 x B x D in all),
// against about 20 x D flops. At the star sweep's decoder (B = 19 SNRs x
// 64, L = 31, N = B x L = 37,696 rows, D = 128, bf16) one call moves 58.5
// MB, 17.5 us at the H100 SXM's 3.35 TB/s, against 0.1 GFLOP. Stacked
// contexts (the design before this one, and the JAX model's) made the
// caller write and this kernel read 12 x N x D elements: 115.8 MB, 34.6 us.
// Computed from the shapes.
//
// Design: the TPU kernel keeps D on the 128 lanes and does the head sums as
// an MXU product with a block-diagonal (D, H) matrix; Hopper needs neither.
// One warp per row, kRowsPerBlock consecutive rows (of the flattened B x L)
// per block, no shared memory and no barrier; each lane holds E = D / 32
// consecutive elements of every vector, read with one vector load each,
// all eleven loads of a row (q; kh and vh of the row and of both
// neighbours, by index; ke, ve; ks, vs of its sequence) in flight before
// any use. A neighbour's row is the next or previous warp's own row, so
// its second and third reads are L1 or L2 hits: each row comes once from
// HBM. The loaded bf16 pairs stay packed in registers until their product
// (37 registers a thread at D = 128, against 59 with every vector
// converted to f32 on arrival), so an SM holds more rows in flight. The
// per-head dot product is a per-lane partial sum and a butterfly of
// __shfl_xor_sync over the Dh / E lanes of the head (4 lanes at D = 128,
// Dh = 16). The 5-way softmax and the weighted sum stay in f32 registers;
// each lane stores its E outputs with one vector store. Device time at the
// sweep shape (scripts/kernel_variants.py, NVIDIA H100 80GB HBM3, 700 W):
// 0.0245 ms; with every vector converted to f32 on arrival 0.0275; with
// the block's rows staged in a shared tile behind a barrier 0.031-0.034;
// with a warp sliding over runs of 8 rows 0.045. The kernel allocates
// nothing; the caller passes the output.

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

  // a lane's E elements as loaded (bf16 pairs take half the registers of
  // their f32 values until they are used)
  struct Raw {
    V c[kBytes / kChunk];
  };

  // from device memory (read-only path)
  static __device__ __forceinline__ Raw load(const T* src) {
    Raw r;
#pragma unroll
    for (int c = 0; c < kBytes / kChunk; ++c)
      r.c[c] = __ldg(reinterpret_cast<const V*>(src) + c);
    return r;
  }

  static __device__ __forceinline__ void convert(const Raw& r, float* dst) {
#pragma unroll
    for (int c = 0; c < kBytes / kChunk; ++c) {
      const T* e = reinterpret_cast<const T*>(&r.c[c]);
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
star_satellite_kernel(const T* __restrict__ q, const T* __restrict__ kh,
                      const T* __restrict__ vh, const T* __restrict__ ke,
                      const T* __restrict__ ve, const T* __restrict__ ks,
                      const T* __restrict__ vs, T* __restrict__ out, int n,
                      int len, int lanes_per_head, float sqrt_dh) {
  constexpr int D = 32 * E;
  using Vec = LaneVec<T, E>;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp: no shuffle spans a missing row
  // row (b, i) and its neighbours (b, i + 1) and (b, i - 1), circular
  // over L
  const long long b = row / len;
  const long long i = row - b * len;
  const long long nxt = b * len + (i + 1 == len ? 0 : i + 1);
  const long long prv = b * len + (i == 0 ? len - 1 : i - 1);
  const size_t lo = (size_t)lane * E;

  // every load in flight before any use; contexts in the TPU kernel's
  // order: h_{i+1}, h_i, h_{i-1}, e_i, s
  const typename Vec::Raw qr = Vec::load(q + row * D + lo);
  const T* kp[kContexts] = {kh + nxt * D, kh + row * D, kh + prv * D,
                            ke + row * D, ks + b * D};
  const T* vp[kContexts] = {vh + nxt * D, vh + row * D, vh + prv * D,
                            ve + row * D, vs + b * D};
  typename Vec::Raw kr[kContexts], vr[kContexts];
#pragma unroll
  for (int j = 0; j < kContexts; ++j) kr[j] = Vec::load(kp[j] + lo);
#pragma unroll
  for (int j = 0; j < kContexts; ++j) vr[j] = Vec::load(vp[j] + lo);

  // per-head scores: the lane's partial dot, summed over the head's lanes
  // (an aligned group of lanes_per_head, a power of two)
  float qv[E];
  Vec::convert(qr, qv);
  float s[kContexts];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kContexts; ++j) {
    float kv[E];
    Vec::convert(kr[j], kv);
    float p = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) p = fmaf(qv[e], kv[e], p);
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
    const float wj = __fdiv_rn(s[j], sum);
    float vv[E];
    Vec::convert(vr[j], vv);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(wj, vv[e], acc[e]);
  }
  Vec::store(out + row * D + lo, acc);
}

struct Ring {
  const void *q, *kh, *vh, *ke, *ve, *ks, *vs;
  void* out;
};

template <typename T, int E>
int launch_e(const Ring& r, int n, int len, int dh, void* stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  star_satellite_kernel<T, E>
      <<<blocks, kRowsPerBlock * 32, 0, (cudaStream_t)stream>>>(
          (const T*)r.q, (const T*)r.kh, (const T*)r.vh, (const T*)r.ke,
          (const T*)r.ve, (const T*)r.ks, (const T*)r.vs, (T*)r.out, n, len,
          dh / E, (float)sqrt((double)dh));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Ring& r, int b, int len, int d, int heads, void* stream) {
  if (b <= 0 || len <= 0 || heads <= 0 || d % heads)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)b * len;
  if (n > (1ll << 31) - 1) return (int)cudaErrorInvalidValue;
  const int dh = d / heads;
  // a head spans a power of two of lanes, each holding d / 32 elements
  if (dh < d / 32 || (dh & (dh - 1))) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return launch_e<T, 2>(r, (int)n, len, dh, stream);
    case 128:
      return launch_e<T, 4>(r, (int)n, len, dh, stream);
    case 256:
      return launch_e<T, 8>(r, (int)n, len, dh, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, kh, vh, ke, ve, out: contiguous f32 (B, L, D); ks, vs: contiguous f32
// (B, D); D in {64, 128, 256}, D / heads a power of two >= D / 32. Returns
// cudaGetLastError() after the launch (0 = success).
int deepsc_star_satellite_f32(const void* q, const void* kh, const void* vh,
                              const void* ke, const void* ve, const void* ks,
                              const void* vs, void* out, int b, int len,
                              int d, int heads, void* stream) {
  return launch<float>(Ring{q, kh, vh, ke, ve, ks, vs, out}, b, len, d,
                       heads, stream);
}

// As above with every tensor in bf16.
int deepsc_star_satellite_bf16(const void* q, const void* kh, const void* vh,
                               const void* ke, const void* ve, const void* ks,
                               const void* vs, void* out, int b, int len,
                               int d, int heads, void* stream) {
  return launch<__nv_bfloat16>(Ring{q, kh, vh, ke, ve, ks, vs, out}, b, len,
                               d, heads, stream);
}

}  // extern "C"
