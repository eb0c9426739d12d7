// Fused multi-head attention forward for heads wider than 256, bf16, on
// Hopper's tensor cores (mma.sync, sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` of deepsc_gan_tpu/ops/pallas/
// attention.py where the tuned K1 (csrc/attention_fwd.cu: heads of 8, 16 or
// 32) and the register-held wide kernel (csrc/attention_wide.cu: heads up to
// 256) do not take the width: the wide-heads model's encoder (one head of
// 512) and decoder (2 heads of 320) run here in bf16. The f32 widths stay on
// csrc/attention_wide.cu's chunked CUDA-core kernel (exact f32, which the f32
// step-parity checks need). Same function and roundings as the other K1
// kernels: with q (N, Lq, H*Dh), k and v (N, Lk, H*Dh) bf16 and bias
// (N, Lq, Lk) f32 shared by the heads,
//     s = (q_h . k_h) * (1/scale) + bias    (f32, two roundings)
//     p = exp(s - max) / sum                 (f32)
//     out = pc v_h with pc = p rounded to bf16 (f32 sums, rounded to bf16)
// A fully blocked row (bias -1e9 on every key) gives the near-uniform
// weights the other kernels give: the bias is added as given.
//
// What bounds it: the bytes, and at these sizes the latency of moving them.
// At N = 64, Lq = Lk = 32, one head of 512, a call reads q, k, v (6.3 MB)
// and the bias (0.26 MB) and writes out (2.1 MB): 0.0026 ms at 3.35 TB/s,
// against 0.27 GFLOP (0.3 us on the tensor cores). Two heads of 320 at 31 x
// 31: 0.0031 ms of bytes.
//
// Design: a block of eight warps per (batch row, head, tile of 16 queries,
// group of up to 512 output columns): 256 blocks at the decoder's shape,
// 128 at the encoder's, two a SM. The logits of the 16 queries and a tile of
// 32 keys, S = q_h k_h^T, are one m16n8k16 m-tile by four 8-key n-tiles over
// Dh / 16 k-steps; the k-steps are split among the eight warps (q and k
// staged in chunks of 512 columns, zero past Dh, so any width runs in fixed
// shared memory), each warp's partial S goes to shared memory, and every
// warp adds the eight partials in warp order: all hold the same S bit for
// bit. The softmax runs on the accumulators as in the tuned kernel (a row's
// 32 logits lie in one quad), p is rounded to bf16 as the A operand of
// p . v (the accumulator-to-A identity), and each warp multiplies it by its
// own eighth of the group's columns of v (ldmatrix.trans from the staged
// rows), so no warp holds more than 8 n-tiles of output (32 registers).
// Up to 32 keys there is one key tile and one pass: S is formed once and the
// softmax is exact. Past 32 keys, two passes over the key tiles: the first
// keeps each row's running max and sum (online), the second forms
// p = exp(s - max) / sum exactly and accumulates p . v. Heads past 512
// columns take more than one group, each forming S again (a head of 1,024:
// twice). Queries past Lq and keys past Lk are zero in shared memory (the
// keys masked out of the softmax); every sum runs in a fixed order, the
// same bits on every call. The kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_row.cuh"

namespace {

using mrow::cp_async16;
using mrow::cp_async_wait_all;
using mrow::ldsm_x2_trans;
using mrow::lds32;
using mrow::mma16816;
using mrow::pack_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQ = 16;         // queries a block: one m-tile
constexpr int kK = 32;         // keys a tile: four 8-key n-tiles
constexpr int kChunk = 512;    // columns of q and k staged at a time
constexpr int kGroup = 512;    // output columns a block writes
constexpr int kMaxNT = kGroup / 8 / kWarps;  // n-tiles of output a warp
// bytes between staged rows of kChunk bf16: 65 16-byte units, odd, so the
// eight rows a fragment load or an ldmatrix reads fall in distinct banks
constexpr int kStride = 16 * (kChunk / 8 + 1);
constexpr int kBiasStride = kK + 1;
constexpr size_t kSmemBytes = (size_t)(kQ + 2 * kK) * kStride +
                              sizeof(float) * kQ * kBiasStride +
                              sizeof(float) * kWarps * 16 * 32;

struct Shape {
  int n, lq, lk, heads, dh;
  float inv_scale;
};

__device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// rows [0, rows) and columns [0, cols) of a bf16 row block at src (rows
// `ld` elements apart) -> rows kStride bytes apart at dst; columns
// [cols, pad) of those rows and columns [0, pad) of rows [rows, max_rows)
// set to zero. `vec`: 16-byte cp.async (src 16-byte aligned, ld and cols
// multiples of 8); else element by element.
__device__ __forceinline__ void stage(uint8_t* dst,
                                      const __nv_bfloat16* __restrict__ src,
                                      long long ld, int rows, int max_rows,
                                      int cols, int pad, bool vec, int tid) {
  if (vec) {
    const int units = cols / 8;
    for (int e = tid; e < rows * units; e += kThreads) {
      const int r = e / units;
      const int u = e - r * units;
      cp_async16(dst + r * kStride + 16 * u, src + r * ld + 8 * u);
    }
  } else {
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int r = e / cols;
      const int c = e - r * cols;
      reinterpret_cast<__nv_bfloat16*>(dst + r * kStride)[c] = src[r * ld + c];
    }
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const int tail = pad - cols;
  for (int e = tid; e < rows * tail; e += kThreads) {
    const int r = e / tail;
    reinterpret_cast<__nv_bfloat16*>(dst + r * kStride)[cols + e - r * tail] =
        zero;
  }
  for (int e = tid; e < (max_rows - rows) * pad; e += kThreads) {
    const int r = rows + e / pad;
    reinterpret_cast<__nv_bfloat16*>(dst + r * kStride)[e % pad] = zero;
  }
}

// the quad's max and sum of a value of rows g and g + 8
__device__ __forceinline__ void quad_max(float (&x)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x[r] = fmaxf(x[r], __shfl_xor_sync(0xffffffffu, x[r], 1));
    x[r] = fmaxf(x[r], __shfl_xor_sync(0xffffffffu, x[r], 2));
  }
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_chunked_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const float* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ out, Shape sh,
                                 int vec) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* qs = smem_raw;
  uint8_t* ks = qs + kQ * kStride;
  uint8_t* vs = ks + kK * kStride;
  float* bs = reinterpret_cast<float*>(vs + kK * kStride);
  float* slot = bs + kQ * kBiasStride;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c4 = 4 * (lane & 3);  // byte offset of column 2 (lane % 4)
  const int c2 = 2 * (lane & 3);
  const long long nh = blockIdx.x;
  const int h = (int)(nh % sh.heads);
  const long long n = nh / sh.heads;
  const int q0 = blockIdx.y * kQ;
  const int ql = min(kQ, sh.lq - q0);
  const int c0 = blockIdx.z * kGroup;
  const int gcols = min(kGroup, sh.dh - c0);
  const long long hd = (long long)sh.heads * sh.dh;
  const __nv_bfloat16* qb = q + (n * sh.lq + q0) * hd + (long long)h * sh.dh;
  const __nv_bfloat16* kb = k + n * sh.lk * hd + (long long)h * sh.dh;
  const __nv_bfloat16* vb = v + n * sh.lk * hd + (long long)h * sh.dh + c0;
  const float* bb = bias + (n * sh.lq + q0) * sh.lk;

  const int nchunks = (sh.dh + kChunk - 1) / kChunk;
  const int nkt = (sh.lk + kK - 1) / kK;
  // this warp's n-tiles of the group's output columns
  const int nt_all = (gcols + 7) / 8;
  const int ntw = (nt_all + kWarps - 1) / kWarps;
  const int nt0 = warp * ntw;
  const int ntc = max(0, min(ntw, nt_all - nt0));

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[kMaxNT][4];
#pragma unroll
  for (int dn = 0; dn < kMaxNT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  // pass 0 (past 32 keys only): each row's max and sum; pass 1: p . v
  for (int pass = nkt > 1 ? 0 : 1; pass < 2; ++pass) {
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * kK;
      const int kl = min(kK, sh.lk - k0);
      __syncthreads();  // the last tile's reads of the staged rows are done
      if (pass == 1)
        stage(vs, vb + k0 * hd, hd, kl, kK, gcols, round_up(gcols, 8),
              vec != 0, tid);
      for (int e = tid; e < kQ * kK; e += kThreads) {
        const int i = e / kK;
        const int j = e - i * kK;
        bs[i * kBiasStride + j] =
            i < ql && j < kl ? bb[(long long)i * sh.lk + k0 + j] : 0.f;
      }
      // this warp's partial logits over its k-steps of every chunk
      float sp[4][4];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[nj][e] = 0.f;
      for (int ch = 0; ch < nchunks; ++ch) {
        const int cc0 = ch * kChunk;
        const int cols = min(kChunk, sh.dh - cc0);
        if (ch > 0) __syncthreads();  // the last chunk's reads are done
        stage(qs, qb + cc0, hd, ql, kQ, cols, round_up(cols, 16), vec != 0,
              tid);
        stage(ks, kb + k0 * hd + cc0, hd, kl, kK, cols, round_up(cols, 16),
              vec != 0, tid);
        cp_async_wait_all();
        __syncthreads();
        const int nks = (cols + 15) / 16;
        const int kper = (nks + kWarps - 1) / kWarps;
        const int k_hi = min(nks, (warp + 1) * kper);
        for (int kk = warp * kper; kk < k_hi; ++kk) {
          const uint8_t* qr = qs + g * kStride + 32 * kk + c4;
          uint32_t qa[4];
          qa[0] = lds32(qr);
          qa[1] = lds32(qr + 8 * kStride);
          qa[2] = lds32(qr + 16);
          qa[3] = lds32(qr + 8 * kStride + 16);
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            const uint8_t* kr = ks + (8 * nj + g) * kStride + 32 * kk + c4;
            mma16816(sp[nj], qa, lds32(kr), lds32(kr + 16));
          }
        }
      }
      // S: the eight partials added in warp order, in every warp
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          slot[(warp * 16 + 4 * nj + e) * 32 + lane] = sp[nj][e];
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = slot[(4 * nj + e) * 32 + lane];
          for (int w = 1; w < kWarps; ++w)
            x += slot[(w * 16 + 4 * nj + e) * 32 + lane];
          // the logit, rounded twice; keys past the tile's at -inf
          const int i = g + 8 * (e >> 1);
          const int j = 8 * nj + c2 + (e & 1);
          sc[nj][e] = j < kl ? __fadd_rn(__fmul_rn(x, sh.inv_scale),
                                         bs[i * kBiasStride + j])
                             : -INFINITY;
        }
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[nj][e]);
      quad_max(tmax);
      if (pass == 0) {
        // the running max and sum
        float se[2] = {0.f, 0.f};
        float mn[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) mn[r] = fmaxf(m[r], tmax[r]);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            se[e >> 1] += expf(sc[nj][e] - mn[e >> 1]);
        mrow::quad_sum(se);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * expf(m[r] - mn[r]) + se[r];
          m[r] = mn[r];
        }
        continue;
      }
      if (nkt == 1) {
        // one tile: the exact max and sum
        m[0] = tmax[0];
        m[1] = tmax[1];
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nj][e] = expf(sc[nj][e] - m[e >> 1]);
      if (nkt == 1) {
        l[0] = l[1] = 0.f;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e >> 1] += sc[nj][e];
        mrow::quad_sum(l);
      }
      // p = e / sum rounded to bf16: n-tiles 2 kk and 2 kk + 1 are the A
      // operand of k-step kk of p . v
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* x = sc[2 * kk + half];
          pa[kk][2 * half] =
              pack_bf16(__fdiv_rn(x[0], l[0]), __fdiv_rn(x[1], l[0]));
          pa[kk][2 * half + 1] =
              pack_bf16(__fdiv_rn(x[2], l[1]), __fdiv_rn(x[3], l[1]));
        }
#pragma unroll
      for (int dn = 0; dn < kMaxNT; ++dn) {
        if (dn >= ntc) continue;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, vs + (16 * kk + (lane & 15)) * kStride +
                                    16 * (nt0 + dn));
          mma16816(o[dn], pa[kk], b0, b1);
        }
      }
    }
  }

  // rows g and g + 8 of the tile, columns c0 + 8 (nt0 + dn) + c2 (+ 0, 1)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = g + 8 * half;
    if (i >= ql) continue;
    __nv_bfloat16* orow = out + ((n * sh.lq + q0 + i) * sh.heads + h) *
                                    (long long)sh.dh;
#pragma unroll
    for (int dn = 0; dn < kMaxNT; ++dn) {
      if (dn >= ntc) continue;
      const int col = c0 + 8 * (nt0 + dn) + c2;
      const float x0 = o[dn][2 * half];
      const float x1 = o[dn][2 * half + 1];
      if (col + 1 < sh.dh && vec) {
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(x0, x1);
      } else {
        if (col < sh.dh) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < sh.dh) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (any shape).
size_t deepsc_attention_chunked_smem_bytes(void) { return kSmemBytes; }

// q, out: contiguous bf16 (N, Lq, heads*dh); k, v: (N, Lk, heads*dh); bias:
// contiguous f32 (N, Lq, Lk); all 16-byte aligned; any N, Lq, Lk, heads and
// dh >= 1 (the wrapper sends heads wider than 256). Returns
// cudaGetLastError() after the launch (0 = success).
int deepsc_attention_chunked_fwd_bf16(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* out, int n, int lq, int lk,
                                      int heads, int dh, double scale,
                                      void* stream) {
  if (n <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || dh <= 0)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      attention_fwd_chunked_mma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err) return err;
  // 1/scale in double, rounded once to f32, as the other kernels
  const Shape sh{n, lq, lk, heads, dh, (float)(1.0 / scale)};
  const dim3 grid((unsigned)((long long)n * heads),
                  (unsigned)((lq + kQ - 1) / kQ),
                  (unsigned)((dh + kGroup - 1) / kGroup));
  attention_fwd_chunked_mma_kernel<<<grid, kThreads, kSmemBytes,
                                     (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)bias, (__nv_bfloat16*)out, sh,
      dh % 8 == 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
