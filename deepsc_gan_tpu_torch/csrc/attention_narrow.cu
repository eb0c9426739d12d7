// Fused multi-head attention forward (K1) and backward (K2) in f32 at the
// tuned head shapes (heads of 8, 16 or 32 columns, at most 16 heads), any
// length, on Hopper's CUDA cores (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// deepsc_gan_tpu/ops/pallas/attention.py for every f32 call at those heads:
// the main model (d_model 128, 8 heads of 16) trains and decodes here at
// `--dtype float32`, the precision the reference trains in (bf16 takes
// csrc/attention_fwd.cu and csrc/attention_bwd.cu; f32 at other heads the
// tiled kernels, csrc/attention_tiled.cu and csrc/attention_bwd_tiled.cu).
// Same function and roundings as the plain version: with q (N, Lq, H*Dh),
// k and v (N, Lk, H*Dh), bias (N, Lq, Lk) f32 and g shaped like q,
//     s = (q_h . k_h) * (1/scale) + bias   (f32, two roundings, no fma
//                                           across them)
//     p = exp(s - max) / sum               (f32)
//     out = p v_h
//     dv = p^T g, dp = g v^T, ds = p (dp - rowsum(dp p)),
//     dq = dss k, dk = dss^T q with dss = ds * (1/scale),
//     dbias = sum_h ds (heads in order 0..H-1),
// every product in exact f32 on the CUDA cores (no TF32; the f32 step
// parity and greedy id checks need it). The bias is added as given: no
// -inf, no skipped keys, so a row whose keys are all blocked gives the same
// near-uniform weights as the TPU kernel.
//
// What bounds it: bytes, and at the training shape the launch and each
// block's chain of dependent steps. At N = 64, Lq = Lk = 31, 8 heads of 16
// K1 reads q, k, v and the bias and writes out: 4.3 MB, 0.0013 ms at the
// H100 SXM's 3.35 TB/s (its 16 MFLOP take 0.0002 ms at 67 TFLOP/s); K2
// reads q, k, v, g and the bias and writes dq, dk and dv: 7.6 MB, 0.0023
// ms. On an H100 80GB HBM3 at 700 W (scripts/kernel_variants.py) K1 takes
// 0.0068 ms there, of which the staging and the stores alone (no logits,
// softmax or sums) take 0.0041; K2 0.0113, of which 0.0046-0.0051. What is
// left is instructions: 256 fmaf a lane against about 70 shared-memory
// reads, the exponentials and the divisions; at the serving shape (N =
// 1,216) K1 takes 0.066 against 0.035 for its staging alone and a 0.025
// bound. The design before this one (a block per batch row holding every
// head, a thread per query running the row's logits, softmax and context
// serially; K2's block of 129 KB, one an SM, 64 blocks in all; the keys
// staged through registers; IEEE divisions) took 0.0166-0.0169 (K1) and
// 0.0261-0.0269 ms (K2) there, 0.097-0.110 (K1) at the serving shape.
//
// Design: a block of 128 threads per (batch row, head, tile of 32 queries
// or keys): 512 blocks at the training shape, four or more an SM. Four
// lanes of a warp (a quad) take one query (or key): lane c its keys (or
// queries) c, c + 4, ..., c + 28 of a tile of 32 and its Dh/4 columns of
// the output, so a row's max, sum and rowsum(dp p) are each a lane's
// partial, summed in order, then a butterfly of two shuffles, which gives
// every lane of the quad the same bits. The rows of q, k, v and g and the
// bias tile are staged by cp.async (16-byte copies; 4-byte ones for the
// bias, whose rows seldom start on 16 bytes) at strides that keep a warp's
// reads in distinct banks, double-buffered where tiles stream (the key-side
// kernel reads its own key's rows, bias column and statistics from device
// memory into registers while the staging is in flight); p and dss go
// through shared memory so that each output element is one lane's sum over
// the keys (or queries) in order by fmaf.
// Every sum has a fixed order and every output element one writer (no
// atomics): the same bits on every call, dq, dk and dv the same with or
// without dbias. The divisions e / sum are `div_rn` (csrc/mma_row.cuh: the
// IEEE quotient wherever it is normal, at half the instructions).
// - K1: the keys in tiles of 32, double-buffered. One tile (Lk <= 32): the
//   exact softmax, p = e / sum, then out = sum_j p_j v_j. More tiles: an
//   online softmax (the running max m and sum l, l and the context rescaled
//   by exp(m_old - m_new)), out = (sum_j e_j v_j) / l.
// - K2 up to 32 queries and keys: one kernel, a block per (row, head)
//   holding the head's q, g, k, v, bias tile, p and dss (24 KB at heads of
//   16): a quad per query forms s, dp, p, rowsum and ds, then a quad per
//   query sums dq over the keys and a quad per key dk and dv over the
//   queries. Past 32 of either, the row statistics (m, l, rowsum) in K1's
//   order over key tiles (with one key tile they are the short kernel's
//   sums, so p is K1's), then p = exp(s - m) / l, in two kernels that pass
//   the statistics through the caller's scratch: a block per (row, head,
//   query tile) streams the key tiles twice (the statistics, then p, ds and
//   dq), a block per (row, head, key tile) streams the query tiles (p and
//   ds again from the statistics, dk and dv).
// - dbias: each head's ds to the caller's scratch, summed over the heads
//   in order 0..H-1 by a last kernel, an element a thread.
// The kernels allocate nothing; the caller passes the outputs and scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_stage.cuh"
#include "mma_row.cuh"

namespace {

using cps::commit;
using cps::stage;
using cps::wait_group;
using mrow::div_rn;

constexpr int kThreads = 128;  // 32 rows x 4 lanes
constexpr int kRows = 32;      // queries (or keys) a block, keys a tile
constexpr int kPer = 8;        // keys (or queries) of a tile a lane takes
constexpr int kMaxHeads = 16;
// a row of p or dss in shared memory (lane c of row r writes column c + 4 u:
// banks 4 r + c, distinct over a warp's 8 rows; rows read 16 bytes at a
// time)
constexpr int kRowStride = kRows + 4;
// K1's blocks an SM (its launch bounds: at most 64 registers a thread).
// Built without them (96 registers, 5 blocks an SM) K1 took 17 % longer at
// the serving shape, 1.5 % at the training one; built for 6, 10 % longer at
// the serving shape (H100, scripts/kernel_variants.py: fwd_blocks_6).
constexpr int kFwdBlocks = 8;

struct Shape {
  int n, lq, lk, heads;
  float inv_scale;
};

// a row of q, k, v or g in shared memory: 4 floats past Dh, so that the
// 16-byte reads of the 4 rows a quarter-warp reads fall in distinct banks
__host__ __device__ constexpr int vs(int dh) { return dh + 4; }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// the quad's sum, the same bits in each of its lanes
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// N floats (2 or a multiple of 4) between registers and memory, 16 bytes
// a move (8 when N == 2)
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
  } else {
#pragma unroll
    for (int d = 0; d < N; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + d);
      dst[d] = x.x;
      dst[d + 1] = x.y;
      dst[d + 2] = x.z;
      dst[d + 3] = x.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&src)[N]) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
#pragma unroll
    for (int d = 0; d < N; d += 4)
      *reinterpret_cast<float4*>(dst + d) =
          make_float4(src[d], src[d + 1], src[d + 2], src[d + 3]);
  }
}

// acc[x] = fmaf(w, row[x], acc[x]) over a lane's Dh/4 columns
template <int N>
__device__ __forceinline__ void axpy(float (&acc)[N], float w,
                                     const float* row) {
  float x[N];
  load_row(x, row);
#pragma unroll
  for (int d = 0; d < N; ++d) acc[d] = fmaf(w, x[d], acc[d]);
}

// a . row over d in order 0..DH-1 by fmaf (DH a multiple of 4)
template <int DH>
__device__ __forceinline__ float dot(const float (&a)[DH], const float* row) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + d);
    acc = fmaf(a[d], x.x, acc);
    acc = fmaf(a[d + 1], x.y, acc);
    acc = fmaf(a[d + 2], x.z, acc);
    acc = fmaf(a[d + 3], x.w, acc);
  }
  return acc;
}

// rows [0, 32) of a head's Dh columns of a (L, H*Dh) tensor from row r0
// into shared memory at stride vs(DH), zeros past row `length`
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, const float* head,
                                           long long hd, int r0, int length) {
  stage<kThreads, true>(dst, vs(DH), head + r0 * hd, hd, kRows, DH,
                        length - r0, DH);
}

// (b, h, tile) of a block over (N, H, tiles)
struct Block {
  long long b, bh;
  int h, t0;
};

__device__ __forceinline__ Block block_of(const Shape& sh, int length) {
  const int tiles = (length + kRows - 1) / kRows;
  const long long blk = blockIdx.x;
  Block o;
  o.t0 = (int)(blk % tiles) * kRows;
  o.bh = blk / tiles;
  o.h = (int)(o.bh % sh.heads);
  o.b = o.bh / sh.heads;
  return o;
}

// the (32, 32) tile of the bias at (q0, k0) at row stride kRowStride,
// zeros past the row's queries and keys (4-byte copies: a row of 31 floats
// seldom starts on 16 bytes)
__device__ __forceinline__ void stage_bias(float* dst, const float* bias_row,
                                           int lk, int q0, int k0, int lq) {
  stage<kThreads, false>(dst, kRowStride, bias_row + (long long)q0 * lk + k0,
                         lk, kRows, kRows, lq - q0, lk - k0);
}

// a lane's 8 values c + 4 u of its row of a staged bias tile
__device__ __forceinline__ void read_bias(float (&dst)[kPer],
                                          const float* row, int c) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) dst[u] = row[c + 4 * u];
}

// a head's row of DH floats from device memory into registers (zeros for a
// row past the tensor's)
template <int DH>
__device__ __forceinline__ void load_head_row(float (&dst)[DH],
                                              const float* row, bool valid) {
  if (valid) {
    load_row(dst, row);
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[d] = 0.f;
  }
}

// acc += sum over j < n, in order, of w[j] row_j (a lane's Dh/4 columns of
// rows at stride S from `rows`), w read 4 at a time (w 16-byte aligned,
// with room for 4 past n)
template <int C>
__device__ __forceinline__ void weighted_rows(float (&acc)[C],
                                              const float* w,
                                              const float* rows, int S,
                                              int n) {
  for (int j0 = 0; j0 < n; j0 += 4) {
    const float4 x = *reinterpret_cast<const float4*>(w + j0);
    const float wj[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + e < n) axpy(acc, wj[e], rows + (j0 + e) * S);
  }
}

// ---- K1 ----

// Shared memory (floats): the query tile (32 x vs); `stages` stages of k
// and v (32 x vs each) and the bias tile (32 x kRowStride); then p (32 x
// kRowStride).
__host__ __device__ constexpr int kv_floats(int dh) {
  return 2 * kRows * vs(dh);
}

__host__ __device__ constexpr int fwd_stage_floats(int dh) {
  return kv_floats(dh) + kRows * kRowStride;
}

__host__ __device__ constexpr int fwd_smem_floats(int dh, int stages) {
  return kRows * vs(dh) + stages * fwd_stage_floats(dh) + kRows * kRowStride;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
attention_narrow_fwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            float* __restrict__ out, Shape sh) {
  constexpr int C = DH / 4;  // columns of the output a lane
  constexpr int S = vs(DH);
  constexpr int QF = kRows * S;  // the query tile
  extern __shared__ __align__(16) float smem[];
  const Block blk = block_of(sh, sh.lq);
  const int q0 = blk.t0;
  const long long hd = (long long)sh.heads * DH;
  const long long col = (long long)blk.h * DH;
  const int tid = threadIdx.x;
  const int i = tid >> 2;  // the query of this quad
  const int c = tid & 3;   // the lane of the quad
  const bool valid = q0 + i < sh.lq;
  const int nkt = (sh.lk + kRows - 1) / kRows;
  float* prow =
      smem + QF + (nkt > 1 ? 2 : 1) * fwd_stage_floats(DH) + i * kRowStride;
  const float* kb = k + blk.b * sh.lk * hd + col;
  const float* vb = v + blk.b * sh.lk * hd + col;
  const float* bb = bias + blk.b * sh.lq * sh.lk;
  const auto issue = [&](int t) {
    float* st = smem + QF + (t & 1) * fwd_stage_floats(DH);
    stage_rows<DH>(st, kb, hd, t * kRows, sh.lk);
    stage_rows<DH>(st + kRows * S, vb, hd, t * kRows, sh.lk);
    stage_bias(st + kv_floats(DH), bb, sh.lk, q0, t * kRows, sh.lq);
    commit();
  };
  float qv[DH];
  stage_rows<DH>(smem, q + blk.b * sh.lq * hd + col, hd, q0, sh.lq);
  issue(0);

  float ctx[C];
#pragma unroll
  for (int d = 0; d < C; ++d) ctx[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int t = 0; t < nkt; ++t) {
    const int kn = min(kRows, sh.lk - t * kRows);
    if (t + 1 < nkt) {
      issue(t + 1);
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    if (t == 0) load_row(qv, smem + i * S);
    const float* ks = smem + QF + (t & 1) * fwd_stage_floats(DH);
    const float* vsm = ks + kRows * S;
    float s[kPer];
    read_bias(s, vsm + kRows * S + i * kRowStride, c);
    // the logits of this lane's keys c + 4 u, and the tile's max
    float tm = -INFINITY;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = c + 4 * u;
      if (j < kn) {
        s[u] = __fadd_rn(__fmul_rn(dot<DH>(qv, ks + j * S), sh.inv_scale),
                         s[u]);
        tm = fmaxf(tm, s[u]);
      }
    }
    tm = quad_max(tm);
    if (nkt == 1) {
      // the exact softmax: p = e / sum
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (c + 4 * u < kn) {
          s[u] = expf(s[u] - tm);
          part = __fadd_rn(part, s[u]);
        }
      const float sum = quad_sum(part);
      const float r = __frcp_rn(sum);
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (c + 4 * u < kn) prow[c + 4 * u] = div_rn(s[u], sum, r);
    } else {
      // online: the running max and sum, the context rescaled
      const float mn = fmaxf(m, tm);
      const float alpha = expf(m - mn);
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (c + 4 * u < kn) {
          s[u] = expf(s[u] - mn);
          part = __fadd_rn(part, s[u]);
          prow[c + 4 * u] = s[u];
        }
      l = __fadd_rn(__fmul_rn(l, alpha), quad_sum(part));
#pragma unroll
      for (int d = 0; d < C; ++d) ctx[d] = __fmul_rn(ctx[d], alpha);
      m = mn;
    }
    __syncwarp();
    // this lane's columns of the context over the tile's keys in order
    weighted_rows(ctx, prow, vsm + c * C, S, kn);
    __syncthreads();  // the stage is free for the tile after next
  }
  if (!valid) return;
  if (nkt > 1) {
#pragma unroll
    for (int d = 0; d < C; ++d) ctx[d] = __fdiv_rn(ctx[d], l);
  }
  store_row(out + (blk.b * sh.lq + q0 + i) * hd + col + c * C, ctx);
}

// ---- K2 up to 32 queries and keys: one kernel ----

// Shared memory (floats): q, g, k, v (32 x vs each), p, dss and the bias
// tile (32 x kRowStride each).
__host__ __device__ constexpr int bwd_smem_floats(int dh) {
  return 4 * kRows * vs(dh) + 3 * kRows * kRowStride;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attention_narrow_bwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            const float* __restrict__ g,
                            float* __restrict__ dq, float* __restrict__ dk,
                            float* __restrict__ dv,
                            float* __restrict__ ds_out, Shape sh) {
  constexpr int C = DH / 4;
  constexpr int S = vs(DH);
  extern __shared__ __align__(16) float smem[];
  const Block blk = block_of(sh, 1);
  const long long hd = (long long)sh.heads * DH;
  const long long col = (long long)blk.h * DH;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // the query (phases 1, 2) or key (phase 3)
  const int c = tid & 3;
  float* qs = smem;
  float* gs = qs + kRows * S;
  float* ks = gs + kRows * S;
  float* vsm = ks + kRows * S;
  float* ps = vsm + kRows * S;
  float* ws = ps + kRows * kRowStride;
  const long long qat = blk.b * sh.lq * hd + col;
  const long long kat = blk.b * sh.lk * hd + col;
  stage_rows<DH>(qs, q + qat, hd, 0, sh.lq);
  stage_rows<DH>(gs, g + qat, hd, 0, sh.lq);
  stage_rows<DH>(ks, k + kat, hd, 0, sh.lk);
  stage_rows<DH>(vsm, v + kat, hd, 0, sh.lk);
  stage_bias(ws + kRows * kRowStride, bias + blk.b * sh.lq * sh.lk, sh.lk, 0,
             0, sh.lq);
  commit();
  wait_group<0>();
  __syncthreads();
  float s[kPer], dp[kPer];
  read_bias(s, ws + kRows * kRowStride + r * kRowStride, c);

  // ---- 1. a quad per query: s, dp, p, rowsum(dp p), ds and dss
  {
    float qv[DH], gv[DH];
    load_row(qv, qs + r * S);
    load_row(gv, gs + r * S);
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = c + 4 * u;
      dp[u] = 0.f;
      if (j < sh.lk) {
        s[u] = __fadd_rn(__fmul_rn(dot<DH>(qv, ks + j * S), sh.inv_scale),
                         s[u]);
        dp[u] = dot<DH>(gv, vsm + j * S);
        m = fmaxf(m, s[u]);
      }
    }
    m = quad_max(m);
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (c + 4 * u < sh.lk) {
        s[u] = expf(s[u] - m);
        part = __fadd_rn(part, s[u]);
      }
    const float sum = quad_sum(part);
    const float rs = __frcp_rn(sum);
    float racc = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (c + 4 * u < sh.lk) {
        s[u] = div_rn(s[u], sum, rs);
        racc = fmaf(s[u], dp[u], racc);
      }
    const float rowsum = quad_sum(racc);
    float* dsg = ds_out != nullptr && r < sh.lq
                     ? ds_out + (blk.bh * sh.lq + r) * sh.lk
                     : nullptr;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = c + 4 * u;
      if (j < sh.lk) {
        const float ds = __fmul_rn(s[u], __fsub_rn(dp[u], rowsum));
        ps[r * kRowStride + j] = s[u];
        ws[r * kRowStride + j] = __fmul_rn(ds, sh.inv_scale);
        if (dsg != nullptr) dsg[j] = ds;
      }
    }
  }
  __syncthreads();

  // ---- 2. a quad per query: dq = sum over the keys of dss k
  if (r < sh.lq) {
    float acc[C];
#pragma unroll
    for (int d = 0; d < C; ++d) acc[d] = 0.f;
    weighted_rows(acc, ws + r * kRowStride, ks + c * C, S, sh.lk);
    store_row(dq + qat + r * hd + c * C, acc);
  }
  // ---- 3. a quad per key: dk = sum over the queries of dss q, dv of p g
  if (r < sh.lk) {
    float ak[C], av[C];
#pragma unroll
    for (int d = 0; d < C; ++d) ak[d] = av[d] = 0.f;
    for (int i = 0; i < sh.lq; ++i) {
      axpy(ak, ws[i * kRowStride + r], qs + i * S + c * C);
      axpy(av, ps[i * kRowStride + r], gs + i * S + c * C);
    }
    store_row(dk + kat + r * hd + c * C, ak);
    store_row(dv + kat + r * hd + c * C, av);
  }
}

// ---- K2 past 32 queries or keys: two kernels through the statistics ----

// the dq kernel's shared memory (floats): the q and g tiles (32 x vs each);
// two stages of k and v (32 x vs each) and the bias tile (32 x
// kRowStride); then dss (32 x kRowStride)
__host__ __device__ constexpr int dq_smem_floats(int dh) {
  return 2 * kRows * vs(dh) + 2 * fwd_stage_floats(dh) + kRows * kRowStride;
}

// a block per (row, head, query tile): pass 0 streams the key tiles for
// each query's max m, sum l and rowsum(dp p) (l and the sum of e dp
// rescaled by exp(m_old - m_new)); pass 1 streams them again for p, ds and
// dss and sums dq over the keys; writes (m, l, rowsum) to `stats` (N, H,
// Lq) and, with dbias, ds to `ds_out` (N, H, Lq, Lk).
template <int DH>
__global__ void __launch_bounds__(kThreads)
attention_narrow_dq_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ bias,
                           const float* __restrict__ g,
                           float* __restrict__ dq,
                           float4* __restrict__ stats,
                           float* __restrict__ ds_out, Shape sh) {
  constexpr int C = DH / 4;
  constexpr int S = vs(DH);
  extern __shared__ __align__(16) float smem[];
  const Block blk = block_of(sh, sh.lq);
  const int q0 = blk.t0;
  const long long hd = (long long)sh.heads * DH;
  const long long col = (long long)blk.h * DH;
  const int tid = threadIdx.x;
  const int i = tid >> 2;
  const int c = tid & 3;
  constexpr int QF = 2 * kRows * S;  // the q and g tiles
  const bool valid = q0 + i < sh.lq;
  const int nkt = (sh.lk + kRows - 1) / kRows;
  float* wrow = smem + QF + 2 * fwd_stage_floats(DH) + i * kRowStride;
  const float* kb = k + blk.b * sh.lk * hd + col;
  const float* vb = v + blk.b * sh.lk * hd + col;
  const float* bb = bias + blk.b * sh.lq * sh.lk;
  const auto issue = [&](int t) {
    const int k0 = (t % nkt) * kRows;
    float* st = smem + QF + (t & 1) * fwd_stage_floats(DH);
    stage_rows<DH>(st, kb, hd, k0, sh.lk);
    stage_rows<DH>(st + kRows * S, vb, hd, k0, sh.lk);
    stage_bias(st + kv_floats(DH), bb, sh.lk, q0, k0, sh.lq);
    commit();
  };
  const long long qat = (blk.b * sh.lq + q0 + i) * hd + col;
  float qv[DH], gv[DH], acc[C];
  stage_rows<DH>(smem, q + blk.b * sh.lq * hd + col, hd, q0, sh.lq);
  stage_rows<DH>(smem + kRows * S, g + blk.b * sh.lq * hd + col, hd, q0,
                 sh.lq);
  issue(0);
#pragma unroll
  for (int d = 0; d < C; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f, racc = 0.f, rowsum = 0.f, rl = 0.f;
  float* dsg = ds_out != nullptr && valid
                   ? ds_out + (blk.bh * sh.lq + q0 + i) * sh.lk
                   : nullptr;
  for (int t = 0; t < 2 * nkt; ++t) {
    const int k0 = (t % nkt) * kRows;
    const int kn = min(kRows, sh.lk - k0);
    if (t + 1 < 2 * nkt) {
      issue(t + 1);
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    if (t == 0) {
      load_row(qv, smem + i * S);
      load_row(gv, smem + kRows * S + i * S);
    }
    const float* ks = smem + QF + (t & 1) * fwd_stage_floats(DH);
    const float* vsm = ks + kRows * S;
    float s[kPer], dp[kPer];
    read_bias(s, vsm + kRows * S + i * kRowStride, c);
    float tm = -INFINITY;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = c + 4 * u;
      dp[u] = 0.f;
      if (j < kn) {
        s[u] = __fadd_rn(__fmul_rn(dot<DH>(qv, ks + j * S), sh.inv_scale),
                         s[u]);
        dp[u] = dot<DH>(gv, vsm + j * S);
        tm = fmaxf(tm, s[u]);
      }
    }
    if (t < nkt) {
      // pass 0: the statistics
      const float mn = fmaxf(m, quad_max(tm));
      const float alpha = expf(m - mn);
      float pl = 0.f, pr = 0.f;
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (c + 4 * u < kn) {
          const float e = expf(s[u] - mn);
          pl = __fadd_rn(pl, e);
          pr = fmaf(e, dp[u], pr);
        }
      l = __fadd_rn(__fmul_rn(l, alpha), quad_sum(pl));
      racc = __fadd_rn(__fmul_rn(racc, alpha), quad_sum(pr));
      m = mn;
      if (t == nkt - 1) {
        rowsum = __fdiv_rn(racc, l);
        rl = __frcp_rn(l);
      }
    } else {
      // pass 1: p, ds, dss; dq over the tile's keys in order
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int j = c + 4 * u;
        if (j < kn) {
          const float p = div_rn(expf(s[u] - m), l, rl);
          const float ds = __fmul_rn(p, __fsub_rn(dp[u], rowsum));
          wrow[j] = __fmul_rn(ds, sh.inv_scale);
          if (dsg != nullptr) dsg[k0 + j] = ds;
        }
      }
      __syncwarp();
      weighted_rows(acc, wrow, ks + c * C, S, kn);
    }
    __syncthreads();  // the stage is free for the tile after next
  }
  if (!valid) return;
  if (c == 0)
    stats[blk.bh * sh.lq + q0 + i] = make_float4(m, l, rowsum, 0.f);
  store_row(dq + qat + c * C, acc);
}

// the dk/dv kernel's shared memory (floats): two stages of q and g (32 x
// vs each), then p and dss by key (32 x kRowStride each)
__host__ __device__ constexpr int dkv_smem_floats(int dh) {
  return 2 * kv_floats(dh) + 2 * kRows * kRowStride;
}

// a block per (row, head, key tile), a quad per key: streams the query
// tiles, p and ds again from their statistics, and sums dk and dv over the
// queries in order.
template <int DH>
__global__ void __launch_bounds__(kThreads)
attention_narrow_dkv_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            const float* __restrict__ g,
                            float* __restrict__ dk, float* __restrict__ dv,
                            const float4* __restrict__ stats, Shape sh) {
  constexpr int C = DH / 4;
  constexpr int S = vs(DH);
  extern __shared__ __align__(16) float smem[];
  const Block blk = block_of(sh, sh.lk);
  const int k0 = blk.t0;
  const long long hd = (long long)sh.heads * DH;
  const long long col = (long long)blk.h * DH;
  const int tid = threadIdx.x;
  const int j = tid >> 2;  // the key of this quad
  const int c = tid & 3;
  const bool valid = k0 + j < sh.lk;
  const int nqt = (sh.lq + kRows - 1) / kRows;
  float* prow = smem + 2 * kv_floats(DH) + j * kRowStride;
  float* wrow = prow + kRows * kRowStride;
  const float* qb = q + blk.b * sh.lq * hd + col;
  const float* gb = g + blk.b * sh.lq * hd + col;
  const float4* sb = stats + blk.bh * sh.lq;
  const auto issue = [&](int t) {
    float* st = smem + (t & 1) * kv_floats(DH);
    stage_rows<DH>(st, qb, hd, t * kRows, sh.lq);
    stage_rows<DH>(st + kRows * S, gb, hd, t * kRows, sh.lq);
    commit();
  };
  issue(0);
  const long long kat = (blk.b * sh.lk + k0 + j) * hd + col;
  float kv[DH], vv[DH], ak[C], av[C];
  load_head_row(kv, k + kat, valid);
  load_head_row(vv, v + kat, valid);
#pragma unroll
  for (int d = 0; d < C; ++d) ak[d] = av[d] = 0.f;
  // bias column k0 + j of the rows of a query tile
  const float* bcol = bias + blk.b * sh.lq * sh.lk + k0 + j;
  for (int t = 0; t < nqt; ++t) {
    const int q0 = t * kRows;
    const int qn = min(kRows, sh.lq - q0);
    float bv[kPer];
    float4 x[kPer];  // m, l, rowsum of this lane's queries
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = c + 4 * u;
      const bool ok = valid && i < qn;
      bv[u] = ok ? __ldg(bcol + (long long)(q0 + i) * sh.lk) : 0.f;
      x[u] = i < qn ? __ldg(sb + q0 + i) : make_float4(0.f, 1.f, 0.f, 0.f);
    }
    if (t + 1 < nqt) {
      issue(t + 1);
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    const float* qsm = smem + (t & 1) * kv_floats(DH);
    const float* gsm = qsm + kRows * S;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = c + 4 * u;
      if (i < qn) {
        const float s = __fadd_rn(
            __fmul_rn(dot<DH>(kv, qsm + i * S), sh.inv_scale), bv[u]);
        const float dp = dot<DH>(vv, gsm + i * S);
        const float p = div_rn(expf(s - x[u].x), x[u].y, __frcp_rn(x[u].y));
        const float ds = __fmul_rn(p, __fsub_rn(dp, x[u].z));
        prow[i] = p;
        wrow[i] = __fmul_rn(ds, sh.inv_scale);
      }
    }
    __syncwarp();
    weighted_rows(ak, wrow, qsm + c * C, S, qn);
    weighted_rows(av, prow, gsm + c * C, S, qn);
    __syncthreads();  // the stage is free for the tile after next
  }
  if (!valid) return;
  store_row(dk + kat + c * C, ak);
  store_row(dv + kat + c * C, av);
}

// dbias = sum over heads 0..H-1 of ds: an element a thread
__global__ void attention_narrow_dbias_kernel(const float* __restrict__ ds,
                                              float* __restrict__ dbias,
                                              Shape sh) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)sh.lq * sh.lk;
  if (e >= (long long)sh.n * per) return;
  const long long b = e / per, ij = e - b * per;
  float acc = 0.f;
  for (int h = 0; h < sh.heads; ++h)
    acc = __fadd_rn(acc, ds[(b * sh.heads + h) * per + ij]);
  dbias[e] = acc;
}

// ---- launch ----

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

long long blocks(const Shape& sh, int length) {
  return (long long)sh.n * sh.heads * ((length + kRows - 1) / kRows);
}

// past one tile of queries or keys: K2 is the statistics pair
bool is_long(int lq, int lk) { return lq > kRows || lk > kRows; }

template <int DH>
int fwd(const void* q, const void* k, const void* v, const void* bias,
        void* out, const Shape& sh, cudaStream_t st) {
  const size_t smem = sizeof(float) * fwd_smem_floats(DH, sh.lk > kRows ? 2
                                                                        : 1);
  const auto kernel = attention_narrow_fwd_kernel<DH>;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<(unsigned)blocks(sh, sh.lq), kThreads, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (float*)out, sh);
  return (int)cudaGetLastError();
}

template <int DH>
int bwd(const void* q, const void* k, const void* v, const void* bias,
        const void* g, void* dq, void* dk, void* dv, float* stats, float* ds,
        const Shape& sh, cudaStream_t st) {
  int err;
  if (!is_long(sh.lq, sh.lk)) {
    const size_t smem = sizeof(float) * bwd_smem_floats(DH);
    const auto kernel = attention_narrow_bwd_kernel<DH>;
    if ((err = set_smem(kernel, smem))) return err;
    kernel<<<(unsigned)blocks(sh, 1), kThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
        (const float*)g, (float*)dq, (float*)dk, (float*)dv, ds, sh);
    return (int)cudaGetLastError();
  }
  const size_t smem_a = sizeof(float) * dq_smem_floats(DH);
  const size_t smem_b = sizeof(float) * dkv_smem_floats(DH);
  const auto ka = attention_narrow_dq_kernel<DH>;
  const auto kb = attention_narrow_dkv_kernel<DH>;
  if ((err = set_smem(ka, smem_a)) || (err = set_smem(kb, smem_b)))
    return err;
  ka<<<(unsigned)blocks(sh, sh.lq), kThreads, smem_a, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (const float*)g, (float*)dq, (float4*)stats, ds, sh);
  if ((err = (int)cudaGetLastError())) return err;
  kb<<<(unsigned)blocks(sh, sh.lk), kThreads, smem_b, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (const float*)g, (float*)dk, (float*)dv, (const float4*)stats, sh);
  return (int)cudaGetLastError();
}

bool bad(int n, int lq, int lk, int heads, int dh) {
  return n <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || heads > kMaxHeads ||
         (dh != 8 && dh != 16 && dh != 32);
}

Shape shape(int n, int lq, int lk, int heads, double scale) {
  // 1/scale in double, rounded once to f32: the TPU kernel's
  // `s * (1.0 / scale)` with a Python-float scale
  return Shape{n, lq, lk, heads, (float)(1.0 / scale)};
}

}  // namespace

extern "C" {

// f32 floats of the scratch deepsc_attention_narrow_bwd_f32 needs: the row
// statistics (N, heads, Lq, 4) past 32 queries or keys, then with dbias
// each head's ds (N, heads, Lq, Lk); 0 when neither.
long long deepsc_attention_narrow_bwd_scratch_f32(int n, int lq, int lk,
                                                  int heads, int with_dbias) {
  const long long rows = (long long)n * heads * lq;
  return (is_long(lq, lk) ? 4 * rows : 0) + (with_dbias ? rows * lk : 0);
}

// q, out: contiguous f32 (N, Lq, heads*dh), 16-byte aligned; k, v: (N, Lk,
// heads*dh); bias: contiguous f32 (N, Lq, Lk); dh 8, 16 or 32, heads up to
// 16, any N, Lq and Lk. Returns cudaGetLastError() after the launch (0 =
// success).
int deepsc_attention_narrow_fwd_f32(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* out, int n, int lq, int lk,
                                    int heads, int dh, double scale,
                                    void* stream) {
  if (bad(n, lq, lk, heads, dh)) return (int)cudaErrorInvalidValue;
  const Shape sh = shape(n, lq, lk, heads, scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 8:
      return fwd<8>(q, k, v, bias, out, sh, st);
    case 16:
      return fwd<16>(q, k, v, bias, out, sh, st);
    default:
      return fwd<32>(q, k, v, bias, out, sh, st);
  }
}

// q, g, dq: contiguous f32 (N, Lq, heads*dh); k, v, dk, dv: (N, Lk,
// heads*dh); bias: contiguous f32 (N, Lq, Lk); dbias f32 (N, Lq, Lk) or
// null; scratch: f32 of deepsc_attention_narrow_bwd_scratch_f32's floats
// (16-byte aligned), or null where that is 0. Returns cudaGetLastError()
// after the launches (0 = success).
int deepsc_attention_narrow_bwd_f32(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* g, void* dq, void* dk,
                                    void* dv, void* dbias, void* scratch,
                                    int n, int lq, int lk, int heads, int dh,
                                    double scale, void* stream) {
  if (bad(n, lq, lk, heads, dh)) return (int)cudaErrorInvalidValue;
  if (deepsc_attention_narrow_bwd_scratch_f32(n, lq, lk, heads,
                                              dbias != nullptr) > 0 &&
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const Shape sh = shape(n, lq, lk, heads, scale);
  cudaStream_t st = (cudaStream_t)stream;
  float* stats = is_long(lq, lk) ? (float*)scratch : nullptr;
  float* ds = dbias == nullptr ? nullptr
              : (float*)scratch +
                    (is_long(lq, lk) ? 4LL * n * heads * lq : 0);
  int err;
  switch (dh) {
    case 8:
      err = bwd<8>(q, k, v, bias, g, dq, dk, dv, stats, ds, sh, st);
      break;
    case 16:
      err = bwd<16>(q, k, v, bias, g, dq, dk, dv, stats, ds, sh, st);
      break;
    default:
      err = bwd<32>(q, k, v, bias, g, dq, dk, dv, stats, ds, sh, st);
  }
  if (err || dbias == nullptr) return err;
  const long long total = (long long)n * lq * lk;
  attention_narrow_dbias_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                  st>>>(ds, (float*)dbias, sh);
  return (int)cudaGetLastError();
}

}  // extern "C"
