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
// input type feeds dv only; ds uses the f32 p and the f32 dp; dss = (ds *
// (1/scale)) rounded to the input type feeds dq and dk. dq, dk, dv are
// summed in f32 and rounded once to the input type; dbias stays f32. A
// null dbias pointer skips its reduction and write (the mask bias of the
// training path needs no gradient).
//
// What bounds it: memory. At the training path's decoder self-attention
// (N = 64, Lq = Lk = 31, H = 8, Dh = 16, bf16, no dbias) one call reads q,
// k, v, g (1.0 MB) and the bias (0.25 MB) and writes dq, dk, dv (0.76 MB):
// 2.0 MB, 0.0012 ms at the H100 SXM's 3.35 TB/s, against 5 products of
// 64 x 8 x 31 x 31 x 16 multiply-adds (0.08 us at the bf16 tensor-core
// rate). At so few bytes the launch and each block's chain of dependent
// steps set the time: 0.0068-0.0072 ms a call at the training shapes, of
// which the loads and stores alone take 0.0036-0.0039 (no products or
// softmax), on an NVIDIA H100 80GB HBM3 at 700 W (scripts/
// kernel_variants.py); the design before this one, f32 staging and
// CUDA-core products in a block per row, took 0.023.
//
// bf16 only (f32 at these heads runs csrc/attention_narrow.cu). Up to 32
// queries and keys one kernel, below; past 32 of either, the long-length
// kernels further down (query tiles and key tiles of 32; two kernels, dq
// then dk and dv), which the wrapper takes only past 512 of either: up to
// 128 queries and keys csrc/attention_bwd_resident.cu takes the call, up to
// 512 csrc/attention_bwd_cluster.cu.
// - tensor cores (mma.sync m16n8k16, f32 accumulators; the staging,
//   the quad softmax and the division are K1's, csrc/mma_row.cuh). A warp
//   takes one head of one batch row. Without dbias a block takes
//   kHeadsPerBlock = 4 heads of a row: 128 blocks at the training shape
//   (one per row, 64 blocks, left half the SMs idle and took 3-6 % longer;
//   a block per head, 512 blocks, took 18-21 % longer, each block staging
//   the whole bias tile for one head). With dbias a block takes all H heads
//   of its row, so that the sum over heads runs in shared memory in the
//   fixed order 0..H-1. The block copies its columns of the row's q, g, k,
//   v (16-byte cp.async, as bf16) and the bias tile (4-byte cp.async) into
//   shared memory, rows padded to an odd number of 16-byte units, and
//   zeroes the rows past Lq (q, g) and Lk (k, v): a product over them then
//   adds exact zeros, never a stale NaN. Per 16-query tile: S = q k^T and
//   p = e / sum on the accumulators (keys past Lk at -inf, `div_rn`, as
//   K1); dP = g v^T lands in the same layout, so ds = p (dp - rowsum) is
//   elementwise plus two shuffles for the row sum; p and ds of queries
//   past Lq are set to 0. pc and dss, rounded to bf16 and packed in pairs,
//   are the A operand of dQ = dss k as they stand (the accumulator-to-A
//   identity; k through ldmatrix.trans). dK = dss^T q and dV = pc^T g take
//   the transposes: movmatrix.trans turns each packed 8 x 8 block into its
//   transpose's A fragment in registers (writing them to a warp-private
//   shared tile and reading them back with ldmatrix.x4.trans measured the
//   same to within 1.5 %), and q and g are the B operands through
//   ldmatrix.trans. The results go over the warp's
//   own columns of the staged q, k and v, and the block writes them with
//   16-byte stores. No float atomics: every sum runs in a fixed order, and
//   a head's arithmetic does not depend on the block it shares, so two
//   calls give the same bits, with or without dbias.
// The kernels allocate nothing; the caller passes the outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_row.cuh"

namespace {

constexpr int kMaxHeads = 16;  // one warp per head: <= 512 threads

// ---- bf16: tensor cores (csrc/mma_row.cuh) ----

using namespace mrow;

// heads a block takes without dbias: the largest divisor of H up to this
// (kMaxHeads: all H, a block per batch row, as always with dbias)
constexpr int kHeadsPerBlock = 4;

// Shared memory (bf16): qs, gs, ks, vs (kRows rows of the block's columns
// each); bs (kRows x kBiasStride f32); with dbias, per warp the f32 tile
// of ds (kRows x kBiasStride).
size_t smem_bytes_bf16(int hpb, int dh, bool with_dbias) {
  const size_t stride = row_stride(hpb * dh * 2 / 16);
  size_t bytes = 4 * kRows * stride + sizeof(float) * kRows * kBiasStride;
  if (with_dbias) bytes += (size_t)hpb * sizeof(float) * kRows * kBiasStride;
  return bytes;
}

// the C fragment c (rows r0, r0 + 8; columns 2 (t % 4), + 1 of an 8-column
// n-tile starting at byte `at` of row 0) rounded to bf16 into staged rows
__device__ __forceinline__ void store_c(uint8_t* at, int stride,
                                        const float (&c)[4]) {
  *reinterpret_cast<uint32_t*>(at) = pack_bf16(c[0], c[1]);
  *reinterpret_cast<uint32_t*>(at + 8 * stride) = pack_bf16(c[2], c[3]);
}

// The A fragments of the transpose of a 32 x 32 matrix X (queries x keys)
// held as packed bf16 pairs in the accumulator layout of two 16-query
// m-tiles x four 8-key n-tiles (xp[mi][nj][half]: rows 16 mi + g + 8 half,
// columns 8 nj + 2 (t % 4), + 1): at[m][kk], 16 keys from 16 m x 16
// queries from 16 kk, each 8 x 8 block transposed in registers.
__device__ __forceinline__ void transpose_a(uint32_t (&at)[2][2][4],
                                            const uint32_t (&xp)[2][4][2]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      at[m][kk][0] = movmatrix_trans(xp[kk][2 * m][0]);
      at[m][kk][1] = movmatrix_trans(xp[kk][2 * m + 1][0]);
      at[m][kk][2] = movmatrix_trans(xp[kk][2 * m][1]);
      at[m][kk][3] = movmatrix_trans(xp[kk][2 * m + 1][1]);
    }
}

// Fragments as in csrc/mma_row.cuh. Grid (N, H / heads per block), a warp
// per head.
template <int DH>
__global__ void __launch_bounds__(kMaxHeads * 32)
attention_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ g,
                         __nv_bfloat16* __restrict__ dq,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv,
                         float* __restrict__ dbias, int lq, int lk, int heads,
                         float inv_scale) {
  constexpr int KS = (DH + 15) / 16;  // k-steps of q . k and g . v
  constexpr int NT = DH / 8;          // 8-column n-tiles of dq, dk, dv
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int hpb = blockDim.x >> 5;
  const int row_bytes = heads * DH * 2;  // a row in device memory
  const int chunks = hpb * DH * 2 / 16;  // the block's columns of it
  const int stride = row_stride(chunks);
  uint8_t* qs = smem_raw;
  uint8_t* gs = qs + kRows * stride;
  uint8_t* ks = gs + kRows * stride;
  uint8_t* vs = ks + kRows * stride;
  float* bs = reinterpret_cast<float*>(vs + kRows * stride);
  float* ds_tiles = bs + kRows * kBiasStride;  // with dbias

  const long long n = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long col0 = (long long)blockIdx.y * hpb * DH * 2;
  const long long q_at = n * lq * row_bytes + col0;
  const long long k_at = n * lk * row_bytes + col0;
  const auto bytes = [](const __nv_bfloat16* t) {
    return reinterpret_cast<const uint8_t*>(t);
  };
  stage_rows<2>({qs, gs}, stride, {bytes(q) + q_at, bytes(g) + q_at},
                row_bytes, lq, chunks, tid, nt);
  stage_rows<2>({ks, vs}, stride, {bytes(k) + k_at, bytes(v) + k_at},
                row_bytes, lk, chunks, tid, nt);
  stage_bias(bs, bias + n * lq * lk, lq, lk, tid, nt);
  zero_rows<2>({qs, gs}, stride, lq, chunks, tid, nt);
  zero_rows<2>({ks, vs}, stride, lk, chunks, tid, nt);
  cp_async_wait_all();
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;            // fragment row g
  const int c4 = 4 * (lane & 3);       // byte offset of column 2 (t % 4)
  const int col = warp * DH * 2;       // this warp's head in a staged row
  const int mq = lq > 16 ? 2 : 1;      // 16-row tiles of queries
  const int mk = lk > 16 ? 2 : 1;      // 16-row tiles of keys
  float* ds_tile = ds_tiles + warp * kRows * kBiasStride;

  // B fragments of k and v as keys x Dh (keys 8 nj + g): S and dP
  uint32_t kb[4][KS][2], vb[4][KS][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int o = (8 * nj + gr) * stride + col + c4;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      kb[nj][s][0] = lds32(ks + o + 32 * s);
      kb[nj][s][1] = DH >= 16 ? lds32(ks + o + 32 * s + 16) : 0u;
      vb[nj][s][0] = lds32(vs + o + 32 * s);
      vb[nj][s][1] = DH >= 16 ? lds32(vs + o + 32 * s + 16) : 0u;
    }
  }

  // per 16-query tile: p and ds, packed in bf16 pairs (pcp: p; dsp: ds *
  // (1/scale)), and dQ
  uint32_t pcp[2][4][2], dsp[2][4][2];
  float dqa[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        pcp[mi][nj][half] = dsp[mi][nj][half] = 0u;
    if (mi >= mq) continue;
    const int r0 = 16 * mi + gr;  // this thread's rows r0 and r0 + 8
    uint32_t qa[KS][4], ga[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int o = r0 * stride + col + c4 + 32 * s;
      qa[s][0] = lds32(qs + o);
      qa[s][1] = lds32(qs + o + 8 * stride);
      qa[s][2] = DH >= 16 ? lds32(qs + o + 16) : 0u;
      qa[s][3] = DH >= 16 ? lds32(qs + o + 8 * stride + 16) : 0u;
      ga[s][0] = lds32(gs + o);
      ga[s][1] = lds32(gs + o + 8 * stride);
      ga[s][2] = DH >= 16 ? lds32(gs + o + 16) : 0u;
      ga[s][3] = DH >= 16 ? lds32(gs + o + 8 * stride + 16) : 0u;
    }
    float p[4][4], dp[4][4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nj][e] = dp[nj][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        mma16816(p[nj], qa[s], kb[nj][s][0], kb[nj][s][1]);
        mma16816(dp[nj], ga[s], vb[nj][s][0], vb[nj][s][1]);
      }
    }
    float sum[2];
    softmax_exp(p, bs, r0, c4 >> 1, lk, inv_scale, sum);
    const float rs[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
    // p (f32; 0 for queries past lq) and rowsum(dp p) over the quad
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = div_rn(p[nj][e], sum[r], rs[r]);
        p[nj][e] = r0 + 8 * r < lq ? x : 0.f;
        rowsum[r] = __fadd_rn(rowsum[r], __fmul_rn(dp[nj][e], p[nj][e]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 1);
      rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 2);
    }
    // ds = p (dp - rowsum) in f32 (into dp), then the packed operands
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nj][e] = __fmul_rn(p[nj][e], __fsub_rn(dp[nj][e], rowsum[e >> 1]));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        pcp[mi][nj][half] = pack_bf16(p[nj][2 * half], p[nj][2 * half + 1]);
        dsp[mi][nj][half] =
            pack_bf16(__fmul_rn(dp[nj][2 * half], inv_scale),
                      __fmul_rn(dp[nj][2 * half + 1], inv_scale));
      }
    }
    if (dbias != nullptr) {
      // the unscaled f32 ds for the sum over heads (rows past lq are 0)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(
              ds_tile + (r0 + 8 * half) * kBiasStride + 8 * nj + (c4 >> 1)) =
              make_float2(dp[nj][2 * half], dp[nj][2 * half + 1]);
    }
    // dQ = dss k: dss's n-tiles 2 kk, 2 kk + 1 are the A operand of key
    // k-step kk; k is the B operand through ldmatrix.trans
#pragma unroll
    for (int dn = 0; dn < NT; ++dn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[mi][dn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kk >= mk) continue;
        const uint32_t a[4] = {dsp[mi][2 * kk][0], dsp[mi][2 * kk][1],
                               dsp[mi][2 * kk + 1][0], dsp[mi][2 * kk + 1][1]};
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1,
                      ks + (16 * kk + (lane & 15)) * stride + col + 16 * dn);
        mma16816(dqa[mi][dn], a, b0, b1);
      }
    }
  }

  // dV = pc^T g and dK = dss^T q: 16-key m-tiles, K = queries; g and q are
  // the B operands through ldmatrix.trans
  uint32_t at[2][2][4];
  float acc[2][NT][4];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    uint8_t* src = pass == 0 ? gs : qs;
    if (pass == 0)
      transpose_a(at, pcp);
    else
      transpose_a(at, dsp);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int dn = 0; dn < NT; ++dn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][dn][e] = 0.f;
        if (m >= mk) continue;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (kk >= mq) continue;
          uint32_t b0, b1;
          ldsm_x2_trans(
              b0, b1, src + (16 * kk + (lane & 15)) * stride + col + 16 * dn);
          mma16816(acc[m][dn], at[m][kk], b0, b1);
        }
      }
    // dv over this warp's columns of v (pass 0), dk over those of k (pass
    // 1): only this warp reads them, and it has read them
    uint8_t* dst = pass == 0 ? vs : ks;
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int dn = 0; dn < NT; ++dn)
        if (m < mk)
          store_c(dst + (16 * m + gr) * stride + col + 16 * dn + c4, stride,
                  acc[m][dn]);
  }
  // dq over this warp's columns of q, read for the last time above
  __syncwarp();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int dn = 0; dn < NT; ++dn)
      if (mi < mq)
        store_c(qs + (16 * mi + gr) * stride + col + 16 * dn + c4, stride,
                dqa[mi][dn]);
  __syncthreads();

  const auto out = [](__nv_bfloat16* t) {
    return reinterpret_cast<uint8_t*>(t);
  };
  store_rows<1>({out(dq) + q_at}, row_bytes, {qs}, stride, lq, chunks, tid,
                nt);
  store_rows<2>({out(dk) + k_at, out(dv) + k_at}, row_bytes, {ks, vs},
                stride, lk, chunks, tid, nt);
  if (dbias != nullptr) {
    // the block holds all heads: sum their ds in the order 0..H-1
    float* dbn = dbias + n * lq * lk;
    for (int e = tid; e < lq * lk; e += nt) {
      const int i = e / lk;
      const int o = i * kBiasStride + (e - i * lk);
      float s = 0.f;
      for (int hh = 0; hh < hpb; ++hh)
        s = __fadd_rn(s, ds_tiles[hh * kRows * kBiasStride + o]);
      dbn[e] = s;
    }
  }
}

// ---- any length: query tiles and key tiles ----
//
// Past 32 queries or keys (either) the launch takes two kernels in turn
// (the wrapper takes them only past 512 of either: up to 128 the
// K2 runs csrc/attention_bwd_resident.cu, a batch row's head held whole,
// up to 512 csrc/attention_bwd_cluster.cu), each recomputing the
// probabilities per (query tile, key tile) of 32 x 32 on the tensor cores:
// A. a block per (batch row, tile of 32 queries), a warp per head: pass 1
//    streams the key tiles for each query's softmax statistics, the running
//    max m and sum l (rescaled by exp(m_old - m_new) as in the forward) and
//    rowsum(dp p) as the running sum of exp(logit - m) dp over l; pass 2
//    streams them again for p = exp(logit - m) / l, ds = p (dp - rowsum)
//    and dq = sum over key tiles of dss k, and, with dbias, the sum over the
//    block's heads (all of them, in the order 0..H-1) of each key tile's ds.
//    It writes (m, l, rowsum) per (row, head, query) to the caller's
//    scratch `stats` (N, H, Lq, 4) f32;
// B. a block per (batch row, tile of 32 keys), a warp per head: streams the
//    query tiles with their statistics from `stats`, recomputes p and ds,
//    and sums dv = pc^T g and dk = dss^T q over them.
// Every sum runs in a fixed order and every output element is written by
// one thread of one block: no atomics, so two calls give the same bits,
// with or without dbias (dq, dk and dv never depend on it). The
// statistics come from online sums, so p may differ from the plain
// version's in its last bits.
//
// What bounds it: memory. At N = 64, Lq = Lk = 128, 8 heads of 16 (no
// dbias) a call must move 18.9 MB, 0.0056 ms at 3.35 TB/s, against 1.3
// GFLOP. It took 0.0610 ms of device time on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py), PyTorch's SDPA backward 0.0425: the logits and
// dP are recomputed three times (two passes of A, one of B) and every key
// tile is staged twice per query tile in A; the bf16 B kernel also spills
// (24 bytes at Dh = 16, under the 128-register cap of 512 threads).
// Saving the forward's row statistics would drop A's first pass.

// Shared memory of A: qs, gs (the query tile's rows, all heads), ks, vs
// (a key tile's), bs (kRows x kBiasStride f32), with dbias each head's ds
// tile (kRows x kBiasStride f32); of B: ks, vs (the key tile's), qs, gs (a
// query tile's), bs, and the query tile's statistics of every head
// (H x kRows float4).
size_t smem_bytes_long_bf16(int heads, int dh, bool with_dbias) {
  const size_t stride = row_stride(heads * dh * 2 / 16);
  const size_t bias_tile = sizeof(float) * kRows * kBiasStride;
  const size_t a = 4 * kRows * stride + bias_tile +
                   (with_dbias ? (size_t)heads * bias_tile : 0);
  const size_t b = 4 * kRows * stride + bias_tile +
                   sizeof(float4) * (size_t)heads * kRows;
  return a > b ? a : b;
}

// S = q k^T and dP = g v^T of one 16-query m-tile (rows r0, r0 + 8 of the
// staged q and g) against the 32 keys of the staged k and v
template <int DH>
__device__ __forceinline__ void tile_products(float (&p)[4][4],
                                              float (&dp)[4][4],
                                              const uint8_t* qs,
                                              const uint8_t* gs,
                                              const uint8_t* ks,
                                              const uint8_t* vs, int stride,
                                              int r0, int col, int c4,
                                              int gr) {
  constexpr int KS = (DH + 15) / 16;
  uint32_t qa[KS][4], ga[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int o = r0 * stride + col + c4 + 32 * s;
    qa[s][0] = lds32(qs + o);
    qa[s][1] = lds32(qs + o + 8 * stride);
    qa[s][2] = DH >= 16 ? lds32(qs + o + 16) : 0u;
    qa[s][3] = DH >= 16 ? lds32(qs + o + 8 * stride + 16) : 0u;
    ga[s][0] = lds32(gs + o);
    ga[s][1] = lds32(gs + o + 8 * stride);
    ga[s][2] = DH >= 16 ? lds32(gs + o + 16) : 0u;
    ga[s][3] = DH >= 16 ? lds32(gs + o + 8 * stride + 16) : 0u;
  }
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[nj][e] = dp[nj][e] = 0.f;
    const int o = (8 * nj + gr) * stride + col + c4;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      mma16816(p[nj], qa[s], lds32(ks + o + 32 * s),
               DH >= 16 ? lds32(ks + o + 32 * s + 16) : 0u);
      mma16816(dp[nj], ga[s], lds32(vs + o + 32 * s),
               DH >= 16 ? lds32(vs + o + 32 * s + 16) : 0u);
    }
  }
}

// Stage rows [r0, r0 + rows) of q and g (the block's whole rows) into qs,
// gs, rows past `rows` zeroed.
__device__ __forceinline__ void stage_pair(uint8_t* as, uint8_t* bs2,
                                           const uint8_t* a,
                                           const uint8_t* b, int row_bytes,
                                           int stride, int rows, int tid,
                                           int nt) {
  const int chunks = row_bytes / 16;
  stage_rows<2>({as, bs2}, stride, {a, b}, row_bytes, rows, chunks, tid, nt);
  zero_rows<2>({as, bs2}, stride, rows, chunks, tid, nt);
}

template <int DH>
__global__ void __launch_bounds__(kMaxHeads * 32)
attention_bwd_dq_mma_long_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const float* __restrict__ bias,
                                 const __nv_bfloat16* __restrict__ g,
                                 __nv_bfloat16* __restrict__ dq,
                                 float* __restrict__ dbias,
                                 float4* __restrict__ stats, int lq, int lk,
                                 int heads, float inv_scale) {
  constexpr int NT = DH / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int row_bytes = heads * DH * 2;
  const int stride = row_stride(row_bytes / 16);
  uint8_t* qs = smem_raw;
  uint8_t* gs = qs + kRows * stride;
  uint8_t* ks = gs + kRows * stride;
  uint8_t* vs = ks + kRows * stride;
  float* bs = reinterpret_cast<float*>(vs + kRows * stride);
  float* ds_tiles = bs + kRows * kBiasStride;  // with dbias

  const long long n = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int ql = min(kRows, lq - q0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const auto bytes = [](const __nv_bfloat16* t) {
    return reinterpret_cast<const uint8_t*>(t);
  };
  const long long q_at = (n * lq + q0) * row_bytes;
  stage_pair(qs, gs, bytes(q) + q_at, bytes(g) + q_at, row_bytes, stride, ql,
             tid, nt);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;
  const int c4 = 4 * (lane & 3);
  const int col = warp * DH * 2;
  const int mq = ql > 16 ? 2 : 1;
  float* ds_tile = ds_tiles + warp * kRows * kBiasStride;

  float m[2][2], l[2][2], rowsum[2][2], dqa[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mi][r] = -INFINITY;
      l[mi][r] = rowsum[mi][r] = 0.f;
    }
#pragma unroll
    for (int dn = 0; dn < NT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[mi][dn][e] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < lk; k0 += kRows) {
      const int kl = min(kRows, lk - k0);
      const int mk = kl > 16 ? 2 : 1;
      __syncthreads();  // the last tile's reads are done
      const long long k_at = (n * lk + k0) * row_bytes;
      stage_pair(ks, vs, bytes(k) + k_at, bytes(v) + k_at, row_bytes, stride,
                 kl, tid, nt);
      stage_bias_tile(bs, bias + (n * lq + q0) * lk + k0, ql, kl, lk, tid,
                      nt);
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (mi >= mq) continue;
        const int r0 = 16 * mi + gr;
        float p[4][4], dp[4][4];
        tile_products<DH>(p, dp, qs, gs, ks, vs, stride, r0, col, c4, gr);
        float tmax[2];
        tile_logits(p, bs, r0, c4 >> 1, kl, inv_scale, tmax);
        if (pass == 0) {
          float alpha[2], tl[2] = {0.f, 0.f}, tr[2] = {0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mn = fmaxf(m[mi][r], tmax[r]);
            alpha[r] = expf(m[mi][r] - mn);
            m[mi][r] = mn;
          }
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = expf(p[nj][e] - m[mi][e >> 1]);
              tl[e >> 1] += x;
              tr[e >> 1] = fmaf(x, dp[nj][e], tr[e >> 1]);
            }
          quad_sum(tl);
          quad_sum(tr);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[mi][r] = l[mi][r] * alpha[r] + tl[r];
            rowsum[mi][r] = rowsum[mi][r] * alpha[r] + tr[r];
          }
          continue;
        }
        // pass 1: p, ds, dQ += dss k, and the f32 ds for dbias
        const float rs[2] = {__frcp_rn(l[mi][0]), __frcp_rn(l[mi][1])};
        uint32_t dsp[4][2];
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float x = div_rn(expf(p[nj][e] - m[mi][r]), l[mi][r], rs[r]);
            dp[nj][e] = r0 + 8 * r < ql
                            ? __fmul_rn(x, __fsub_rn(dp[nj][e], rowsum[mi][r]))
                            : 0.f;
          }
#pragma unroll
          for (int half = 0; half < 2; ++half)
            dsp[nj][half] =
                pack_bf16(__fmul_rn(dp[nj][2 * half], inv_scale),
                          __fmul_rn(dp[nj][2 * half + 1], inv_scale));
        }
        if (dbias != nullptr) {
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int half = 0; half < 2; ++half)
              *reinterpret_cast<float2*>(ds_tile +
                                         (r0 + 8 * half) * kBiasStride +
                                         8 * nj + (c4 >> 1)) =
                  make_float2(dp[nj][2 * half], dp[nj][2 * half + 1]);
        }
#pragma unroll
        for (int dn = 0; dn < NT; ++dn)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            if (kk >= mk) continue;
            const uint32_t a[4] = {dsp[2 * kk][0], dsp[2 * kk][1],
                                   dsp[2 * kk + 1][0], dsp[2 * kk + 1][1]};
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, ks + (16 * kk + (lane & 15)) * stride +
                                      col + 16 * dn);
            mma16816(dqa[mi][dn], a, b0, b1);
          }
      }
      if (pass == 1 && dbias != nullptr) {
        __syncthreads();
        float* dbn = dbias + (n * lq + q0) * lk + k0;
        for (int e = tid; e < ql * kl; e += nt) {
          const int i = e / kl;
          const int o = i * kBiasStride + (e - i * kl);
          float s = 0.f;
          for (int hh = 0; hh < heads; ++hh)
            s = __fadd_rn(s, ds_tiles[hh * kRows * kBiasStride + o]);
          dbn[(long long)i * lk + (e - i * kl)] = s;
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          rowsum[mi][r] = __fdiv_rn(rowsum[mi][r], l[mi][r]);
    }
  }
  // the statistics (one lane of each quad) and dq over this warp's columns
  // of the staged q, read for the last time above
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (mi >= mq) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 16 * mi + gr + 8 * r;
      if ((lane & 3) == 0 && i < ql)
        stats[(n * heads + warp) * lq + q0 + i] =
            make_float4(m[mi][r], l[mi][r], rowsum[mi][r], 0.f);
    }
  }
  __syncwarp();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int dn = 0; dn < NT; ++dn)
      if (mi < mq)
        store_c(qs + (16 * mi + gr) * stride + col + 16 * dn + c4, stride,
                dqa[mi][dn]);
  __syncthreads();
  store_rows<1>({reinterpret_cast<uint8_t*>(dq) + q_at}, row_bytes, {qs},
                stride, ql, row_bytes / 16, tid, nt);
}

template <int DH>
__global__ void __launch_bounds__(kMaxHeads * 32)
attention_bwd_dkv_mma_long_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const float* __restrict__ bias,
                                  const __nv_bfloat16* __restrict__ g,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv,
                                  const float4* __restrict__ stats, int lq,
                                  int lk, int heads, float inv_scale) {
  constexpr int NT = DH / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int row_bytes = heads * DH * 2;
  const int chunks = row_bytes / 16;
  const int stride = row_stride(chunks);
  uint8_t* ks = smem_raw;
  uint8_t* vs = ks + kRows * stride;
  uint8_t* qs = vs + kRows * stride;
  uint8_t* gs = qs + kRows * stride;
  float* bs = reinterpret_cast<float*>(gs + kRows * stride);
  float4* st = reinterpret_cast<float4*>(bs + kRows * kBiasStride);

  const long long n = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int kl = min(kRows, lk - k0);
  const int mk = kl > 16 ? 2 : 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const auto bytes = [](const __nv_bfloat16* t) {
    return reinterpret_cast<const uint8_t*>(t);
  };
  const long long k_at = (n * lk + k0) * row_bytes;
  stage_pair(ks, vs, bytes(k) + k_at, bytes(v) + k_at, row_bytes, stride, kl,
             tid, nt);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;
  const int c4 = 4 * (lane & 3);
  const int col = warp * DH * 2;

  float dka[2][NT][4], dva[2][NT][4];
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int dn = 0; dn < NT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[mm][dn][e] = dva[mm][dn][e] = 0.f;

  for (int q0 = 0; q0 < lq; q0 += kRows) {
    const int ql = min(kRows, lq - q0);
    const int mq = ql > 16 ? 2 : 1;
    __syncthreads();  // the last tile's reads are done
    const long long q_at = (n * lq + q0) * row_bytes;
    stage_pair(qs, gs, bytes(q) + q_at, bytes(g) + q_at, row_bytes, stride,
               ql, tid, nt);
    stage_bias_tile(bs, bias + (n * lq + q0) * lk + k0, ql, kl, lk, tid, nt);
    for (int e = tid; e < heads * ql; e += nt) {
      const int hh = e / ql;
      const int r = e - hh * ql;
      cp_async16(st + hh * kRows + r, stats + (n * heads + hh) * lq + q0 + r);
    }
    cp_async_wait_all();
    __syncthreads();

    uint32_t pcp[2][4][2], dsp[2][4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          pcp[mi][nj][half] = dsp[mi][nj][half] = 0u;
      if (mi >= mq) continue;
      const int r0 = 16 * mi + gr;
      float p[4][4], dp[4][4];
      tile_products<DH>(p, dp, qs, gs, ks, vs, stride, r0, col, c4, gr);
      float tmax[2];
      tile_logits(p, bs, r0, c4 >> 1, kl, inv_scale, tmax);
      float4 sr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        sr[r] = r0 + 8 * r < ql ? st[warp * kRows + r0 + 8 * r]
                                : make_float4(0.f, 1.f, 0.f, 0.f);
      const float rs[2] = {__frcp_rn(sr[0].y), __frcp_rn(sr[1].y)};
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool in = r0 + 8 * r < ql;
          const float x =
              in ? div_rn(expf(p[nj][e] - sr[r].x), sr[r].y, rs[r]) : 0.f;
          p[nj][e] = x;
          dp[nj][e] = in ? __fmul_rn(x, __fsub_rn(dp[nj][e], sr[r].z)) : 0.f;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          pcp[mi][nj][half] = pack_bf16(p[nj][2 * half], p[nj][2 * half + 1]);
          dsp[mi][nj][half] =
              pack_bf16(__fmul_rn(dp[nj][2 * half], inv_scale),
                        __fmul_rn(dp[nj][2 * half + 1], inv_scale));
        }
      }
    }
    // dV += pc^T g and dK += dss^T q over this query tile
    uint32_t at[2][2][4];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const uint8_t* src = pass == 0 ? gs : qs;
      if (pass == 0)
        transpose_a(at, pcp);
      else
        transpose_a(at, dsp);
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        if (mm >= mk) continue;
#pragma unroll
        for (int dn = 0; dn < NT; ++dn)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            if (kk >= mq) continue;
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, src + (16 * kk + (lane & 15)) * stride +
                                      col + 16 * dn);
            if (pass == 0)
              mma16816(dva[mm][dn], at[mm][kk], b0, b1);
            else
              mma16816(dka[mm][dn], at[mm][kk], b0, b1);
          }
      }
    }
  }
  // dv and dk over this warp's columns of the staged v and k, read for the
  // last time above
  __syncwarp();
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int dn = 0; dn < NT; ++dn)
      if (mm < mk) {
        const int o = (16 * mm + gr) * stride + col + 16 * dn + c4;
        store_c(vs + o, stride, dva[mm][dn]);
        store_c(ks + o, stride, dka[mm][dn]);
      }
  __syncthreads();
  const auto out = [](__nv_bfloat16* t) {
    return reinterpret_cast<uint8_t*>(t);
  };
  store_rows<2>({out(dk) + k_at, out(dv) + k_at}, row_bytes, {ks, vs},
                stride, kl, chunks, tid, nt);
}

// ---- launch ----

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* bias,
              const void* g, void* dq, void* dk, void* dv, void* dbias,
              int n, int lq, int lk, int heads, float inv_scale,
              cudaStream_t st) {
  // all H heads a block with dbias (for the sum over heads), else the
  // largest divisor of H up to kHeadsPerBlock
  int hpb = heads;
  if (dbias == nullptr)
    for (hpb = heads < kHeadsPerBlock ? heads : kHeadsPerBlock; heads % hpb;
         --hpb) {
    }
  const size_t smem = smem_bytes_bf16(hpb, DH, dbias != nullptr);
  const int err = set_smem(attention_bwd_mma_kernel<DH>, smem);
  if (err) return err;
  attention_bwd_mma_kernel<DH><<<dim3(n, heads / hpb), hpb * 32, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)bias, (const __nv_bfloat16*)g,
      (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      (float*)dbias, lq, lk, heads, inv_scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_long_dh(const void* q, const void* k, const void* v,
                   const void* bias, const void* g, void* dq, void* dk,
                   void* dv, void* dbias, void* stats, int n, int lq, int lk,
                   int heads, float inv_scale, cudaStream_t st) {
  using T = __nv_bfloat16;
  const dim3 grid_q(n, (lq + kRows - 1) / kRows);
  const dim3 grid_k(n, (lk + kRows - 1) / kRows);
  const int threads = heads * 32;
  const size_t smem = smem_bytes_long_bf16(heads, DH, dbias != nullptr);
  int err;
  if ((err = set_smem(attention_bwd_dq_mma_long_kernel<DH>, smem)) ||
      (err = set_smem(attention_bwd_dkv_mma_long_kernel<DH>, smem)))
    return err;
  attention_bwd_dq_mma_long_kernel<DH><<<grid_q, threads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (const T*)g,
      (T*)dq, (float*)dbias, (float4*)stats, lq, lk, heads, inv_scale);
  if ((err = (int)cudaGetLastError())) return err;
  attention_bwd_dkv_mma_long_kernel<DH><<<grid_k, threads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (const T*)g,
      (T*)dk, (T*)dv, (const float4*)stats, lq, lk, heads, inv_scale);
  return (int)cudaGetLastError();
}

// the long-length kernels (long) or the kernel up to 32 queries and keys
int launch(bool long_len, const void* q, const void* k, const void* v,
           const void* bias, const void* g, void* dq, void* dk, void* dv,
           void* dbias, void* stats, int n, int lq, int lk, int heads, int dh,
           double scale, void* stream) {
  if (n <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || heads > kMaxHeads ||
      (!long_len && (lq > kRows || lk > kRows)))
    return (int)cudaErrorInvalidValue;
  // 1/scale in double, rounded once to f32, as the forward
  const float inv_scale = (float)(1.0 / scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 8:
      return long_len ? launch_long_dh<8>(q, k, v, bias, g, dq, dk, dv,
                                          dbias, stats, n, lq, lk, heads,
                                          inv_scale, st)
                      : launch_dh<8>(q, k, v, bias, g, dq, dk, dv, dbias, n,
                                     lq, lk, heads, inv_scale, st);
    case 16:
      return long_len ? launch_long_dh<16>(q, k, v, bias, g, dq, dk, dv,
                                           dbias, stats, n, lq, lk, heads,
                                           inv_scale, st)
                      : launch_dh<16>(q, k, v, bias, g, dq, dk, dv, dbias, n,
                                      lq, lk, heads, inv_scale, st);
    case 32:
      return long_len ? launch_long_dh<32>(q, k, v, bias, g, dq, dk, dv,
                                           dbias, stats, n, lq, lk, heads,
                                           inv_scale, st)
                      : launch_dh<32>(q, k, v, bias, g, dq, dk, dv, dbias, n,
                                      lq, lk, heads, inv_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at most (the wrapper
// checks this against the device's limit before launching; with dbias, a
// block of all heads).
size_t deepsc_attention_bwd_smem_bytes_bf16(int lq, int lk, int heads,
                                            int dh) {
  if (lq > kRows || lk > kRows) return smem_bytes_long_bf16(heads, dh, true);
  return smem_bytes_bf16(heads, dh, true);
}

// q, g, dq, k, v, dk, dv: contiguous bf16 (N, Lq, heads*dh) and (N, Lk,
// heads*dh); bias: contiguous f32 (N, Lq, Lk); dbias: f32 (N, Lq, Lk) or
// null; Lq and Lk up to 32. Returns cudaGetLastError() after the launch
// (0 = success).
int deepsc_attention_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* bias, const void* g, void* dq,
                              void* dk, void* dv, void* dbias, int n, int lq,
                              int lk, int heads, int dh, double scale,
                              void* stream) {
  return launch(false, q, k, v, bias, g, dq, dk, dv, dbias, nullptr, n, lq,
                lk, heads, dh, scale, stream);
}

// Any Lq and Lk (the long-length kernels): as above, and `stats` is the
// caller's f32 scratch (N, heads, Lq, 4), 16-byte aligned.
int deepsc_attention_bwd_long_bf16(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* g, void* dq, void* dk,
                                   void* dv, void* dbias, void* stats, int n,
                                   int lq, int lk, int heads, int dh,
                                   double scale, void* stream) {
  return launch(true, q, k, v, bias, g, dq, dk, dv, dbias, stats, n, lq, lk,
                heads, dh, scale, stream);
}

}  // extern "C"
