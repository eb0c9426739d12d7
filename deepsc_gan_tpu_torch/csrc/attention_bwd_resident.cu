// Fused multi-head attention backward (K2) past 32 queries or keys, up to
// kMaxLen of both, bf16, with a batch row's head resident in shared memory
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_bwd_kernel` of deepsc_gan_tpu/ops/pallas/
// attention.py where the tuned bf16 K2 (csrc/attention_bwd.cu) would take
// the call through its long-length kernels: heads of 8, 16 or 32, at most
// 16 of them, more than 32 queries or keys and at most kMaxLen = 128 of
// each (`cli train --seq-len 64` or 128: each attention's backward). f32,
// and longer rows, stay on csrc/attention_bwd.cu's long-length kernels.
// Same function and roundings as csrc/attention_bwd.cu: for each batch row
// n and head h, p recomputed as the forward computes it (f32 logits `s *
// (1/scale)` then `+ bias`, the exact row max and sum, p = e / sum), dv =
// pc^T g with pc = p rounded to bf16, dp = g v^T (f32), ds = p (dp -
// rowsum(dp p)), dq = dss k and dk = dss^T q with dss = (ds * (1/scale))
// rounded to bf16, dbias = sum over heads 0..H-1 of ds (f32).
//
// What bounds it: memory. At N = 64, Lq = Lk = 128, 8 heads of 16 (no
// dbias) a call must move 18.9 MB, 0.0056 ms at 3.35 TB/s, against 1.3
// GFLOP (0.0013 ms at the bf16 tensor-core rate). The design before this
// one (csrc/attention_bwd.cu's long-length kernels: a block per 32 queries
// streaming 32-key tiles twice, then a block per 32 keys streaming the
// query tiles, the logits and dP formed three times) took 0.0613 ms there
// on an H100 80GB HBM3 at 700 W, SDPA's backward 0.043.
//
// Design: the TPU kernel holds a whole row in VMEM and forms p once per
// head (attention.py:147-192); so does a block here. Block (batch row,
// head) stages the head's q, g, k, v (cp.async, rows of an odd number of
// 16-byte units, rows past Lq and Lk zeroed) and the row's bias tile (f32,
// (Lk + 8 padded) floats a row) once. Phase 1, a warp per 16 queries:
// S = q k^T and dP = g v^T over all Lk keys on the mma.sync accumulators
// (2 KT n-tiles of 8 keys, KT a template: 4 up to 64 keys, 8 up to 128),
// the exact row max and sum over the quad, p, rowsum(dp p) and ds in f32,
// dQ = dss k (the accumulator-to-A identity, k through ldmatrix.trans),
// written at once; pc and dss go to (Lq, Lk) bf16 tiles in shared memory
// (rows of an odd number of 16-byte units). Phase 2, after one block
// barrier, a warp per 16 keys: dV = pc^T g and dK = dss^T q over all
// queries (A read transposed from the tiles by ldmatrix.x4.trans,
// `mrow::dkv_products`). Every output element is written by one thread,
// every sum in a fixed order: no atomics, so two calls give the same bits.
// dbias: each block writes its head's f32 ds to an (N, H, Lq, Lk) scratch
// and a second kernel sums the heads in order (`mrow::sum_dbias`). A block
// needs at most 180 KB of shared memory and 256 threads of up to 255
// registers: one block an SM at 128 x 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_row.cuh"

namespace {

using namespace mrow;

constexpr int kMaxLen = 128;      // queries and keys a block holds
constexpr int kMaxHeads = 16;
constexpr int kThreads = 32 * kMaxLen / 16;

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

// the strides of a block's shared memory at padded lengths lqp and lkp:
// staged rows of a head's q, g, k, v (bytes), bias rows (floats: the
// eight rows of a fragment load fall in distinct banks), pc and dss rows
// (bytes)
__host__ __device__ __forceinline__ int head_stride(int dh) {
  return row_stride(dh * 2 / 16);
}
__host__ __device__ __forceinline__ int bias_stride(int lkp) {
  return lkp + 8;
}
__host__ __device__ __forceinline__ int tile_stride(int lkp) {
  return 2 * lkp + 16;
}

size_t smem_bytes(int lq, int lk, int dh) {
  const size_t lqp = round16(lq), lkp = round16(lk);
  return 2 * (lqp + lkp) * head_stride(dh) +
         sizeof(float) * lqp * bias_stride(lkp) + 2 * lqp * tile_stride(lkp);
}

template <int DH, int KT>
__global__ void __launch_bounds__(kThreads)
attention_bwd_resident_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ g,
                              __nv_bfloat16* __restrict__ dq,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv,
                              float* __restrict__ ds_out, int lq, int lk,
                              int heads, float inv_scale) {
  constexpr int KS = (DH + 15) / 16;  // k-steps of q . k and g . v
  constexpr int NT = DH / 8;          // 8-column n-tiles of dq, dk, dv
  constexpr int NJ = 2 * KT;          // 8-key n-tiles of S and dP
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int lqp = round16(lq), lkp = round16(lk);
  const int stride = head_stride(DH);
  const int bstride = bias_stride(lkp);
  const int pstride = tile_stride(lkp);
  uint8_t* qs = smem_raw;
  uint8_t* gs = qs + lqp * stride;
  uint8_t* ks = gs + lqp * stride;
  uint8_t* vs = ks + lkp * stride;
  float* bs = reinterpret_cast<float*>(vs + lkp * stride);
  uint8_t* ps = reinterpret_cast<uint8_t*>(bs + lqp * bstride);
  uint8_t* dss = ps + lqp * pstride;

  const long long n = blockIdx.x;
  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int hd = heads * DH;
  const int row_bytes = hd * 2;
  constexpr int chunks = DH * 2 / 16;
  const long long col = (long long)head * DH * 2;
  const auto bytes = [](const __nv_bfloat16* t) {
    return reinterpret_cast<const uint8_t*>(t);
  };
  const long long q_at = n * lq * row_bytes + col;
  const long long k_at = n * lk * row_bytes + col;
  stage_rows<2>({qs, gs}, stride, {bytes(q) + q_at, bytes(g) + q_at},
                row_bytes, lq, chunks, tid, nt);
  stage_rows<2>({ks, vs}, stride, {bytes(k) + k_at, bytes(v) + k_at},
                row_bytes, lk, chunks, tid, nt);
  const float* bn = bias + n * lq * lk;
  if (lk % 4 == 0) {  // 16-byte rows
    const int per = lk / 4;
    for (int c = tid; c < lq * per; c += nt) {
      const int i = c / per;
      const int j = 4 * (c - i * per);
      cp_async16(bs + i * bstride + j, bn + (long long)i * lk + j);
    }
  } else {
    for (int e = tid; e < lq * lk; e += nt) {
      const int i = e / lk;
      cp_async4(bs + i * bstride + (e - i * lk), bn + e);
    }
  }
  // rows past lq and lk: a product over them then adds exact zeros
  for (int c = tid; c < (lqp - lq) * chunks; c += nt) {
    const int o = (lq + c / chunks) * stride + 16 * (c % chunks);
    *reinterpret_cast<uint4*>(qs + o) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(gs + o) = make_uint4(0, 0, 0, 0);
  }
  for (int c = tid; c < (lkp - lk) * chunks; c += nt) {
    const int o = (lk + c / chunks) * stride + 16 * (c % chunks);
    *reinterpret_cast<uint4*>(ks + o) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(vs + o) = make_uint4(0, 0, 0, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;         // fragment row g
  const int c4 = 4 * (lane & 3);    // byte offset of column 2 (t % 4)
  const int c2 = 2 * (lane & 3);
  const int nj_used = lkp / 8;      // n-tiles of keys that hold data
  const int kk_used = lkp / 16;     // k-steps of keys

  // ---- phase 1: a warp per 16 queries
  if (warp < lqp / 16) {
    const int r0 = 16 * warp + gr;  // this thread's rows r0 and r0 + 8
    uint32_t qa[KS][4], ga[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int o = r0 * stride + c4 + 32 * s;
      qa[s][0] = lds32(qs + o);
      qa[s][1] = lds32(qs + o + 8 * stride);
      qa[s][2] = DH >= 16 ? lds32(qs + o + 16) : 0u;
      qa[s][3] = DH >= 16 ? lds32(qs + o + 8 * stride + 16) : 0u;
      ga[s][0] = lds32(gs + o);
      ga[s][1] = lds32(gs + o + 8 * stride);
      ga[s][2] = DH >= 16 ? lds32(gs + o + 16) : 0u;
      ga[s][3] = DH >= 16 ? lds32(gs + o + 8 * stride + 16) : 0u;
    }
    float p[NJ][4], dp[NJ][4];
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nj][e] = dp[nj][e] = 0.f;
      if (nj >= nj_used) continue;
      const int o = (8 * nj + gr) * stride + c4;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        mma16816(p[nj], qa[s], lds32(ks + o + 32 * s),
                 DH >= 16 ? lds32(ks + o + 32 * s + 16) : 0u);
        mma16816(dp[nj], ga[s], lds32(vs + o + 32 * s),
                 DH >= 16 ? lds32(vs + o + 32 * s + 16) : 0u);
      }
    }
    // the logits (keys past lk at -inf), the exact row max and sum
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + 8 * (e >> 1);
        const int j = 8 * nj + c2 + (e & 1);
        const float x = j < lk ? __fadd_rn(__fmul_rn(p[nj][e], inv_scale),
                                           bs[i * bstride + j])
                               : -INFINITY;
        p[nj][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[nj][e] = expf(p[nj][e] - mx[e >> 1]);
        sum[e >> 1] += p[nj][e];
      }
    quad_sum(sum);
    // p (f32; 0 for queries past lq), rowsum(dp p), ds = p (dp - rowsum)
    const float rs[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = div_rn(p[nj][e], sum[r], rs[r]);
        p[nj][e] = r0 + 8 * r < lq ? x : 0.f;
        rowsum[r] = __fadd_rn(rowsum[r], __fmul_rn(dp[nj][e], p[nj][e]));
      }
    quad_sum(rowsum);
    uint32_t dsp[NJ][2];  // dss, packed: the A operand of dQ
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nj][e] = __fmul_rn(p[nj][e], __fsub_rn(dp[nj][e], rowsum[e >> 1]));
      if (nj >= nj_used) {
        dsp[nj][0] = dsp[nj][1] = 0u;
        continue;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = (r0 + 8 * half) * pstride + 2 * (8 * nj + c2);
        *reinterpret_cast<uint32_t*>(ps + o) =
            pack_bf16(p[nj][2 * half], p[nj][2 * half + 1]);
        dsp[nj][half] = pack_bf16(__fmul_rn(dp[nj][2 * half], inv_scale),
                                  __fmul_rn(dp[nj][2 * half + 1], inv_scale));
        *reinterpret_cast<uint32_t*>(dss + o) = dsp[nj][half];
      }
    }
    if (ds_out != nullptr) {
      // this head's unscaled f32 ds, summed over heads for dbias
      float* base = ds_out + ((n * heads + head) * lq) * lk;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + 8 * (e >> 1);
          const int j = 8 * nj + c2 + (e & 1);
          if (i < lq && j < lk) base[(long long)i * lk + j] = dp[nj][e];
        }
    }
    // dQ = dss k over the key k-steps; k the B operand (ldmatrix.trans)
    float dqa[NT][4];
    zero_out(dqa);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk >= kk_used) continue;
      const uint32_t a[4] = {dsp[2 * kk][0], dsp[2 * kk][1],
                             dsp[2 * kk + 1][0], dsp[2 * kk + 1][1]};
      const uint8_t* row = ks + (16 * kk + (lane & 15)) * stride;
#pragma unroll
      for (int dn = 0; dn < NT; ++dn) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, row + 16 * dn);
        mma16816(dqa[dn], a, b0, b1);
      }
    }
    store_out<NT>(dq + n * lq * hd + head * DH, hd, dqa, lq, DH, r0, c2, 0,
                  true);
  }
  __syncthreads();

  // ---- phase 2: a warp per 16 keys, over all queries
  if (warp < lkp / 16) {
    float dva[NT][4], dka[NT][4];
    zero_out(dva);
    zero_out(dka);
    dkv_products<NT, kMaxLen / 16>(dva, dka, ps, dss, gs, qs, stride,
                                   lqp / 16, warp, 0, lane, pstride);
    const long long at = n * lk * hd + head * DH;
    store_out<NT>(dv + at, hd, dva, lk, DH, 16 * warp + gr, c2, 0, true);
    store_out<NT>(dk + at, hd, dka, lk, DH, 16 * warp + gr, c2, 0, true);
  }
}

template <int DH, int KT>
const void* kernel_of() {
  return (const void*)attention_bwd_resident_kernel<DH, KT>;
}

// the instance for head width dh and lk keys (null where none is built)
const void* pick(int dh, int lk) {
  const bool short_keys = lk <= kMaxLen / 2;
  switch (dh) {
    case 8:
      return short_keys ? kernel_of<8, 4>() : kernel_of<8, 8>();
    case 16:
      return short_keys ? kernel_of<16, 4>() : kernel_of<16, 8>();
    case 32:
      return short_keys ? kernel_of<32, 4>() : kernel_of<32, 8>();
    default:
      return nullptr;
  }
}

bool takes(int lq, int lk, int heads, int dh) {
  return lq >= 1 && lq <= kMaxLen && lk >= 1 && lk <= kMaxLen &&
         heads >= 1 && heads <= kMaxHeads && pick(dh, lk) != nullptr;
}

int threads(int lq, int lk) {
  return 32 * (round16(lq > lk ? lq : lk) / 16);
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// The block at Lq x Lk and head width dh, into out[3]: its dynamic shared
// memory in bytes, its threads, and the blocks an SM (CUDA's occupancy
// calculator, on the current device). 0 on success, else a CUDA error
// (cudaErrorInvalidValue for a shape the library does not take).
int deepsc_attention_bwd_resident_plan(int lq, int lk, int dh, int* out) {
  if (!takes(lq, lk, 1, dh)) return (int)cudaErrorInvalidValue;
  const void* kernel = pick(dh, lk);
  const size_t smem = smem_bytes(lq, lk, dh);
  out[0] = (int)smem;
  out[1] = threads(lq, lk);
  const int err = set_smem(kernel, smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                            out[1], smem);
}

// q, g, dq: contiguous bf16 (N, Lq, heads*dh); k, v, dk, dv: (N, Lk,
// heads*dh); bias: contiguous f32 (N, Lq, Lk), 16-byte aligned; dh 8, 16
// or 32, heads <= 16, Lq and Lk <= 128; dbias: f32 (N, Lq, Lk) or null,
// and then ds: the caller's f32 scratch (N, heads, Lq, Lk). Returns
// cudaGetLastError() after the launches (0 = success).
int deepsc_attention_bwd_resident_bf16(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* g, void* dq, void* dk,
                                       void* dv, void* dbias, void* ds,
                                       int n, int lq, int lk, int heads,
                                       int dh, double scale, void* stream) {
  if (n <= 0 || !takes(lq, lk, heads, dh) || (dbias != nullptr && !ds))
    return (int)cudaErrorInvalidValue;
  // 1/scale in double, rounded once to f32, as the forward
  const float inv_scale = (float)(1.0 / scale);
  cudaStream_t st = (cudaStream_t)stream;
  const void* kernel = pick(dh, lk);
  const size_t smem = smem_bytes(lq, lk, dh);
  int err = set_smem(kernel, smem);
  if (err) return err;
  using T = __nv_bfloat16;
  float* ds_out = dbias != nullptr ? (float*)ds : nullptr;
  void* args[] = {(void*)&q,  (void*)&k,  (void*)&v,      (void*)&bias,
                  (void*)&g,  (void*)&dq, (void*)&dk,     (void*)&dv,
                  (void*)&ds_out, (void*)&lq, (void*)&lk, (void*)&heads,
                  (void*)&inv_scale};
  static_assert(sizeof(const T*) == sizeof(const void*), "pointer size");
  err = (int)cudaLaunchKernel(kernel, dim3(n, heads), dim3(threads(lq, lk)),
                              args, smem, st);
  if (err) return err;
  if (dbias != nullptr)
    return sum_dbias((const float*)ds, (float*)dbias, n, heads, lq, lk, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
