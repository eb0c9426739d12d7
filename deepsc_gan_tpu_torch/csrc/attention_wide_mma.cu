// Fused multi-head attention, forward and backward, bf16, at the head
// widths and counts the tuned kernels do not take and heads up to 256 wide,
// on Hopper's tensor cores (mma.sync m16n8k16, f32 accumulators, sm_90a),
// plain C interface.
//
// Replaces the TPU kernels `_fwd_kernel` (K1) and `_bwd_kernel` (K2) of
// deepsc_gan_tpu/ops/pallas/attention.py in bf16 where the tuned kernels
// (csrc/attention_fwd.cu, csrc/attention_bwd.cu: heads of 8, 16 or 32, at
// most 16 of them) do not take the shape: the widened model's encoder (8
// heads of 64) and decoder (8 heads of 25), 32 heads of 16, any width from 1
// to 256, any head count, any Lq and Lk. Heads wider than 256 take
// csrc/attention_chunked.cu; f32 stays on csrc/attention_tiled.cu (K1)
// and csrc/attention_bwd_tiled.cu (K2) (exact f32 on the CUDA cores, which
// the f32 step-parity checks need). Same function and order of
// roundings as the other K1/K2 kernels: with q (N, Lq, H*Dh), k and v
// (N, Lk, H*Dh), bias (N, Lq, Lk) f32 shared by the heads and g shaped like q,
//     s = (q_h . k_h) * (1/scale) + bias         (f32, two roundings)
//     p = exp(s - max) / sum                     (f32, div_rn)
//     out = pc v_h, pc = p rounded to bf16       (f32 sums, rounded once)
//     dv = pc^T g, dp = g v^T, ds = p (dp - rowsum(dp p))   (f32)
//     dq = dss k, dk = dss^T q, dss = (ds * (1/scale)) rounded to bf16
//     dbias = sum_h ds                           (f32, heads 0..H-1)
// A fully blocked row (bias -1e9 on every key) gives the near-uniform
// weights the plain version gives: the bias is added as given.
//
// What bounds it: the bytes, and at these sizes the latency of moving them.
// At the widened encoder (N = 64, Lq = Lk = 32, 8 heads of 64) a forward
// reads q, k, v (6.3 MB) and the bias (0.26 MB) and writes out (2.1 MB):
// 0.0026 ms at 3.35 TB/s, against 67 MFLOP (0.07 us on the tensor cores);
// the backward moves 15 MB (0.0045 ms). The design before this one (a warp
// per query, each logit a dot product summed by five shuffles, no shared
// memory) took 0.16 ms forward and 0.36 ms backward there.
//
// Design. A head's columns are zero-padded in shared memory to DP, the next
// of 16, 32, 64, 128 and 256 (25 -> 32, 5 -> 16), a template parameter, so
// q . k runs DP / 16 k-steps with no runtime bound; the pad never touches
// device memory. Staged rows are 2 DP + 16 bytes apart (an odd number of
// 16-byte units: the eight rows a fragment load or ldmatrix reads fall in
// distinct banks). A head whose width is a multiple of 8 goes in with 16-byte
// cp.async; any other starts at a byte offset 2 h Dh that is not a multiple
// of 16, or even of 4, and goes in with 2-byte loads. Rows past Lq or Lk and
// columns past Dh are zero, so a product over them adds exact zeros. A block
// has 2 x CG warps: warp w takes m-tile w % 2 (16 queries; in dK and dV 16
// keys) and column group w / 2 (CG = DP / 64 groups of 64 output columns,
// one below DP = 64), so no warp holds more than 8 n-tiles (32 accumulators)
// of an output; the CG warps of an m-tile each form its S (and dP), at most
// 16 k-steps.
// - Forward: a block per (batch row, head, tile of 32 queries). Up to 32
//   keys the softmax is exact on the accumulators (a row's 32 logits lie in
//   one quad), p rounded to bf16 is the A operand of p . v as it stands (the
//   accumulator-to-A identity) and v the B operand through ldmatrix.trans.
//   Past 32 keys the key tiles of 32 are streamed twice: the running max and
//   sum, then p = exp(s - m) / l exactly and p . v (csrc/attention_chunked.cu's
//   scheme).
// - Backward up to 32 queries and keys: a block per (batch row, head), the
//   tuned K2's order. Phase A, warp (m, c): S = q k^T and dP = g v^T of
//   m-tile m, p and rowsum(dp p) on the accumulators, ds = p (dp - rowsum),
//   and dQ = dss k over its columns; warp (m, 0) writes pc and dss as bf16
//   32 x 32 (query, key) tiles to shared memory. Phase B, warp (m, c):
//   dV = pc^T g and dK = dss^T q for keys 16 m.., their A operands read
//   transposed from those tiles with ldmatrix.x4.trans, g and q the B
//   operands through ldmatrix.trans.
// - Backward past 32 of either: two kernels. The dq kernel, a block per
//   (row, head, tile of 32 queries), streams the key tiles twice (the running
//   max, sum and rowsum, then p, ds and dQ) and writes (m, l, rowsum) per
//   query to the caller's statistics scratch (N, H, Lq, 4); the dk/dv kernel,
//   a block per (row, head, tile of 32 keys), streams the query tiles with
//   their statistics, forms p and ds as phase A does and sums dV and dK as
//   phase B does.
// - dbias, only when asked: the kernels write each head's f32 ds to the
//   caller's scratch (N, H, Lq, Lk) and a last kernel sums it over the heads
//   in the order 0..H-1.
// Every sum runs in a fixed order and every output element has one writer:
// no atomics, the same bits on every call, with or without dbias. The
// kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_row.cuh"

namespace {

using namespace mrow;

constexpr int kT = kRows;  // queries or keys a tile: two 16-row m-tiles

struct Shape {
  int n, lq, lk, heads, dh;
  float inv_scale;
  bool vec;  // dh a multiple of 8: 16-byte staging
};

template <int DP>
struct Cfg {
  static constexpr int KS = DP / 16;                   // k-steps of q . k
  static constexpr int CG = DP > 64 ? DP / 64 : 1;     // column groups
  static constexpr int NTW = (DP > 64 ? 64 : DP) / 8;  // n-tiles a warp
  static constexpr int kThreads = 64 * CG;
  static constexpr int kStride = 2 * DP + 16;  // bytes between staged rows
  // qs, gs, ks, vs; the bias tile; the pc and dss tiles; statistics
  static constexpr size_t kSmem = 4 * (size_t)kT * kStride +
                                  sizeof(float) * kT * kBiasStride +
                                  2 * kT * kPStride + sizeof(float4) * kT;
};

template <int DP>
struct Smem {
  uint8_t *qs, *gs, *ks, *vs, *ps, *dss;
  float* bs;
  float4* st;
  __device__ explicit Smem(uint8_t* raw) {
    constexpr int tile = kT * Cfg<DP>::kStride;
    qs = raw;
    gs = qs + tile;
    ks = gs + tile;
    vs = ks + tile;
    bs = reinterpret_cast<float*>(vs + tile);
    ps = reinterpret_cast<uint8_t*>(bs + kT * kBiasStride);
    dss = ps + kT * kPStride;
    st = reinterpret_cast<float4*>(dss + kT * kPStride);
  }
};

// Where a thread stands: fragment row gr, byte column c4 (= 2 c2) of its
// pair, m-tile m of its warp and the first n-tile t0 of its column group.
struct Lane {
  int tid, lane, gr, c4, c2, m, t0;
  template <int DP>
  __device__ static Lane of() {
    Lane t;
    t.tid = threadIdx.x;
    t.lane = t.tid & 31;
    t.gr = t.lane >> 2;
    t.c2 = 2 * (t.lane & 3);
    t.c4 = 2 * t.c2;
    t.m = (t.tid >> 5) & 1;
    t.t0 = (t.tid >> 6) * Cfg<DP>::NTW;
    return t;
  }
  __device__ int r0() const { return 16 * m + gr; }
  __device__ bool leader() const { return t0 == 0; }  // column group 0
};

// rows [0, rows) of a head's slice (row r at src + r ld, dh elements) -> the
// kT staged rows at dst, zero past dh and from row `rows` on
template <int DP>
__device__ __forceinline__ void stage_head(uint8_t* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           long long ld, int rows, int dh,
                                           bool vec, int tid) {
  constexpr int U = DP / 8;  // 16-byte units a staged row
  for (int e = tid; e < kT * U; e += Cfg<DP>::kThreads) {
    const int r = e / U;
    const int c = 8 * (e - r * U);
    uint8_t* d = dst + r * Cfg<DP>::kStride + 2 * c;
    if (r < rows && vec && c < dh) {
      cp_async16(d, src + r * ld + c);
      continue;
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (r < rows) {
      const unsigned short* s =
          reinterpret_cast<const unsigned short*>(src + r * ld + c);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (c + t < dh) w[t >> 1] |= (uint32_t)s[t] << (16 * (t & 1));
    }
    *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// s = rows r0, r0 + 8 of the staged a times the 32 staged rows of b (n-tile
// nj: rows 8 nj + gr), transposed, over KS k-steps; with kTwo also
// s2 = a2 b2^T in the same loop (S and dP)
template <int DP, bool kTwo>
__device__ __forceinline__ void logit_products(float (&s)[4][4],
                                               float (&s2)[4][4],
                                               const uint8_t* a,
                                               const uint8_t* b,
                                               const uint8_t* a2,
                                               const uint8_t* b2,
                                               const Lane& t) {
  constexpr int stride = Cfg<DP>::kStride;
  zero(s);
  if (kTwo) zero(s2);
  const int oa = t.r0() * stride + t.c4;
  const int ob = t.gr * stride + t.c4;
#pragma unroll
  for (int ks = 0; ks < Cfg<DP>::KS; ++ks) {
    uint32_t fa[4], fa2[4];
    frag_a(fa, a + oa + 32 * ks, stride);
    if (kTwo) frag_a(fa2, a2 + oa + 32 * ks, stride);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int o = ob + 8 * nj * stride + 32 * ks;
      mma16816(s[nj], fa, lds32(b + o), lds32(b + o + 16));
      if (kTwo) mma16816(s2[nj], fa2, lds32(b2 + o), lds32(b2 + o + 16));
    }
  }
}

// ---- forward ----

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads)
wide_mma_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, Shape sh) {
  using C = Cfg<DP>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem<DP> sm(smem_raw);
  const Lane t = Lane::of<DP>();
  const long long nh = blockIdx.x;
  const int h = (int)(nh % sh.heads);
  const long long n = nh / sh.heads;
  const int q0 = blockIdx.y * kT;
  const int ql = min(kT, sh.lq - q0);
  const long long hd = (long long)sh.heads * sh.dh;
  const long long col = (long long)h * sh.dh;
  const __nv_bfloat16* kb = k + n * sh.lk * hd + col;
  const __nv_bfloat16* vb = v + n * sh.lk * hd + col;
  const float* bb = bias + (n * sh.lq + q0) * sh.lk;
  stage_head<DP>(sm.qs, q + (n * sh.lq + q0) * hd + col, hd, ql, sh.dh,
                 sh.vec, t.tid);

  const int nkt = (sh.lk + kT - 1) / kT;
  const bool active = 16 * t.m < ql;  // the warp's m-tile holds queries
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[C::NTW][4];
  zero_out(o);
  // pass 0 (past 32 keys only): each row's running max and sum; pass 1:
  // p . v
  for (int pass = nkt > 1 ? 0 : 1; pass < 2; ++pass) {
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * kT;
      const int kl = min(kT, sh.lk - k0);
      __syncthreads();  // the last tile's reads of the staged rows are done
      stage_head<DP>(sm.ks, kb + k0 * hd, hd, kl, sh.dh, sh.vec, t.tid);
      if (pass == 1)
        stage_head<DP>(sm.vs, vb + k0 * hd, hd, kl, sh.dh, sh.vec, t.tid);
      stage_bias_window(sm.bs, bb + k0, ql, kl, sh.lk, t.tid, C::kThreads);
      cp_async_wait_all();
      __syncthreads();
      if (!active) continue;
      float sc[4][4];
      logit_products<DP, false>(sc, sc, sm.qs, sm.ks, nullptr, nullptr, t);
      float tmax[2];
      tile_logits(sc, sm.bs, t.r0(), t.c2, kl, sh.inv_scale, tmax);
      if (pass == 0) {
        float mn[2], se[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) mn[r] = fmaxf(m[r], tmax[r]);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            se[e >> 1] += expf(sc[nj][e] - mn[e >> 1]);
        quad_sum(se);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * expf(m[r] - mn[r]) + se[r];
          m[r] = mn[r];
        }
        continue;
      }
      if (nkt == 1) {  // one tile: the exact max and sum
        m[0] = tmax[0];
        m[1] = tmax[1];
        l[0] = l[1] = 0.f;
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nj][e] = expf(sc[nj][e] - m[e >> 1]);
          if (nkt == 1) l[e >> 1] += sc[nj][e];
        }
      if (nkt == 1) quad_sum(l);
      const float rs[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nj][e] = div_rn(sc[nj][e], l[e >> 1], rs[e >> 1]);
      uint32_t pk[4][2], a[2][4];
      pack(pk, sc, 1.f);
      to_a(a, pk);
      out_products(o, a, sm.vs, C::kStride, kl > 16 ? 2 : 1, t.lane,
                   t.t0);
    }
  }
  if (active)
    store_out(out + (n * sh.lq + q0) * hd + col, hd, o, ql, sh.dh, t.r0(),
              t.c2, t.t0, (sh.dh & 1) == 0);
}

// ---- backward up to 32 queries and keys: a block per (row, head) ----

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads)
wide_mma_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ g,
                    __nv_bfloat16* __restrict__ dq,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv,
                    float* __restrict__ ds_out, Shape sh) {
  using C = Cfg<DP>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem<DP> sm(smem_raw);
  const Lane t = Lane::of<DP>();
  const long long nh = blockIdx.x;
  const int h = (int)(nh % sh.heads);
  const long long n = nh / sh.heads;
  const long long hd = (long long)sh.heads * sh.dh;
  const long long q_at = n * sh.lq * hd + (long long)h * sh.dh;
  const long long k_at = n * sh.lk * hd + (long long)h * sh.dh;
  stage_head<DP>(sm.qs, q + q_at, hd, sh.lq, sh.dh, sh.vec, t.tid);
  stage_head<DP>(sm.gs, g + q_at, hd, sh.lq, sh.dh, sh.vec, t.tid);
  stage_head<DP>(sm.ks, k + k_at, hd, sh.lk, sh.dh, sh.vec, t.tid);
  stage_head<DP>(sm.vs, v + k_at, hd, sh.lk, sh.dh, sh.vec, t.tid);
  stage_bias_window(sm.bs, bias + n * sh.lq * sh.lk, sh.lq, sh.lk, sh.lk,
                    t.tid, C::kThreads);
  cp_async_wait_all();
  __syncthreads();

  // phase A: p, ds and dQ of m-tile t.m over the warp's columns
  if (16 * t.m < sh.lq) {
    float sc[4][4], dp[4][4];
    logit_products<DP, true>(sc, dp, sm.qs, sm.ks, sm.gs, sm.vs, t);
    float sum[2];
    softmax_exp(sc, sm.bs, t.r0(), t.c2, sh.lk, sh.inv_scale, sum);
    exact_ds(sc, dp, sum, sh.lq, t.r0());
    uint32_t dsk[4][2], a[2][4];
    pack(dsk, dp, sh.inv_scale);
    if (t.leader()) {
      uint32_t pk[4][2];
      pack(pk, sc, 1.f);
      put_tile(sm.ps, pk, t.r0(), t.c2);
      put_tile(sm.dss, dsk, t.r0(), t.c2);
      if (ds_out != nullptr)
        store_ds(ds_out + nh * sh.lq * sh.lk, sh.lk, dp, sh.lq, sh.lk,
                 t.r0(), t.c2);
    }
    float dqa[C::NTW][4];
    zero_out(dqa);
    to_a(a, dsk);
    out_products(dqa, a, sm.ks, C::kStride, sh.lk > 16 ? 2 : 1, t.lane,
                 t.t0);
    store_out(dq + q_at, hd, dqa, sh.lq, sh.dh, t.r0(), t.c2,
              t.t0, (sh.dh & 1) == 0);
  }
  __syncthreads();  // the pc and dss tiles are whole
  // phase B: dV and dK of keys 16 t.m.. over the warp's columns
  if (16 * t.m < sh.lk) {
    float dva[C::NTW][4], dka[C::NTW][4];
    zero_out(dva);
    zero_out(dka);
    dkv_products(dva, dka, sm.ps, sm.dss, sm.gs, sm.qs, C::kStride,
                 sh.lq > 16 ? 2 : 1, t.m, t.t0, t.lane);
    store_out(dv + k_at, hd, dva, sh.lk, sh.dh, t.r0(), t.c2,
              t.t0, (sh.dh & 1) == 0);
    store_out(dk + k_at, hd, dka, sh.lk, sh.dh, t.r0(), t.c2,
              t.t0, (sh.dh & 1) == 0);
  }
}

// ---- backward past 32 queries or keys: dq, then dk and dv ----

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads)
wide_mma_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ g,
                       __nv_bfloat16* __restrict__ dq,
                       float4* __restrict__ stats, float* __restrict__ ds_out,
                       Shape sh) {
  using C = Cfg<DP>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem<DP> sm(smem_raw);
  const Lane t = Lane::of<DP>();
  const long long nh = blockIdx.x;
  const int h = (int)(nh % sh.heads);
  const long long n = nh / sh.heads;
  const int q0 = blockIdx.y * kT;
  const int ql = min(kT, sh.lq - q0);
  const long long hd = (long long)sh.heads * sh.dh;
  const long long col = (long long)h * sh.dh;
  const long long q_at = (n * sh.lq + q0) * hd + col;
  const __nv_bfloat16* kb = k + n * sh.lk * hd + col;
  const __nv_bfloat16* vb = v + n * sh.lk * hd + col;
  const float* bb = bias + (n * sh.lq + q0) * sh.lk;
  stage_head<DP>(sm.qs, q + q_at, hd, ql, sh.dh, sh.vec, t.tid);
  stage_head<DP>(sm.gs, g + q_at, hd, ql, sh.dh, sh.vec, t.tid);

  const bool active = 16 * t.m < ql;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float rowsum[2] = {0.f, 0.f};
  float dqa[C::NTW][4];
  zero_out(dqa);
  const int nkt = (sh.lk + kT - 1) / kT;
  // pass 0: the running max, sum and sum of e dp; pass 1: ds and dQ
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * kT;
      const int kl = min(kT, sh.lk - k0);
      __syncthreads();  // the last tile's reads of the staged rows are done
      stage_head<DP>(sm.ks, kb + k0 * hd, hd, kl, sh.dh, sh.vec, t.tid);
      stage_head<DP>(sm.vs, vb + k0 * hd, hd, kl, sh.dh, sh.vec, t.tid);
      stage_bias_window(sm.bs, bb + k0, ql, kl, sh.lk, t.tid, C::kThreads);
      cp_async_wait_all();
      __syncthreads();
      if (!active) continue;
      float sc[4][4], dp[4][4];
      logit_products<DP, true>(sc, dp, sm.qs, sm.ks, sm.gs, sm.vs, t);
      float tmax[2];
      tile_logits(sc, sm.bs, t.r0(), t.c2, kl, sh.inv_scale, tmax);
      if (pass == 0) {
        float alpha[2], tl[2] = {0.f, 0.f}, tr[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], tmax[r]);
          alpha[r] = expf(m[r] - mn);
          m[r] = mn;
        }
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = expf(sc[nj][e] - m[e >> 1]);
            tl[e >> 1] += x;
            tr[e >> 1] = fmaf(x, dp[nj][e], tr[e >> 1]);
          }
        quad_sum(tl);
        quad_sum(tr);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * alpha[r] + tl[r];
          rowsum[r] = rowsum[r] * alpha[r] + tr[r];
        }
        continue;
      }
      const float rs[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = div_rn(expf(sc[nj][e] - m[r]), l[r], rs[r]);
          dp[nj][e] = t.r0() + 8 * r < ql
                          ? __fmul_rn(p, __fsub_rn(dp[nj][e], rowsum[r]))
                          : 0.f;
        }
      if (ds_out != nullptr && t.leader())
        store_ds(ds_out + (nh * sh.lq + q0) * sh.lk + k0, sh.lk, dp, ql, kl,
                 t.r0(), t.c2);
      uint32_t dsk[4][2], a[2][4];
      pack(dsk, dp, sh.inv_scale);
      to_a(a, dsk);
      out_products(dqa, a, sm.ks, C::kStride, kl > 16 ? 2 : 1, t.lane,
                   t.t0);
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) rowsum[r] = __fdiv_rn(rowsum[r], l[r]);
    }
  }
  if (!active) return;
  if (t.leader() && (t.lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = t.r0() + 8 * r;
      if (i < ql)
        stats[nh * sh.lq + q0 + i] = make_float4(m[r], l[r], rowsum[r], 0.f);
    }
  }
  store_out(dq + q_at, hd, dqa, ql, sh.dh, t.r0(), t.c2, t.t0,
            (sh.dh & 1) == 0);
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads)
wide_mma_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ bias,
                        const __nv_bfloat16* __restrict__ g,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv,
                        const float4* __restrict__ stats, Shape sh) {
  using C = Cfg<DP>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem<DP> sm(smem_raw);
  const Lane t = Lane::of<DP>();
  const long long nh = blockIdx.x;
  const int h = (int)(nh % sh.heads);
  const long long n = nh / sh.heads;
  const int k0 = blockIdx.y * kT;
  const int kl = min(kT, sh.lk - k0);
  const long long hd = (long long)sh.heads * sh.dh;
  const long long col = (long long)h * sh.dh;
  const long long k_at = (n * sh.lk + k0) * hd + col;
  const __nv_bfloat16* qb = q + n * sh.lq * hd + col;
  const __nv_bfloat16* gb = g + n * sh.lq * hd + col;
  stage_head<DP>(sm.ks, k + k_at, hd, kl, sh.dh, sh.vec, t.tid);
  stage_head<DP>(sm.vs, v + k_at, hd, kl, sh.dh, sh.vec, t.tid);

  float dva[C::NTW][4], dka[C::NTW][4];
  zero_out(dva);
  zero_out(dka);
  for (int q0 = 0; q0 < sh.lq; q0 += kT) {
    const int ql = min(kT, sh.lq - q0);
    __syncthreads();  // the last tile's reads of the staged rows are done
    stage_head<DP>(sm.qs, qb + q0 * hd, hd, ql, sh.dh, sh.vec, t.tid);
    stage_head<DP>(sm.gs, gb + q0 * hd, hd, ql, sh.dh, sh.vec, t.tid);
    stage_bias_window(sm.bs, bias + (n * sh.lq + q0) * sh.lk + k0, ql, kl,
                      sh.lk, t.tid, C::kThreads);
    for (int e = t.tid; e < kT; e += C::kThreads) {
      if (e < ql)
        cp_async16(sm.st + e, stats + nh * sh.lq + q0 + e);
      else
        sm.st[e] = make_float4(0.f, 1.f, 0.f, 0.f);
    }
    cp_async_wait_all();
    __syncthreads();
    // phase A, column group 0: pc and dss of query m-tile t.m from the
    // statistics
    if (16 * t.m < ql && t.leader()) {
      float sc[4][4], dp[4][4];
      logit_products<DP, true>(sc, dp, sm.qs, sm.ks, sm.gs, sm.vs, t);
      float tmax[2];
      tile_logits(sc, sm.bs, t.r0(), t.c2, kl, sh.inv_scale, tmax);
      {
        float4 sr[2];
        sr[0] = sm.st[t.r0()];
        sr[1] = sm.st[t.r0() + 8];
        const float rs[2] = {__frcp_rn(sr[0].y), __frcp_rn(sr[1].y)};
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool in = t.r0() + 8 * r < ql;
            const float p =
                in ? div_rn(expf(sc[nj][e] - sr[r].x), sr[r].y, rs[r]) : 0.f;
            sc[nj][e] = p;
            dp[nj][e] = in ? __fmul_rn(p, __fsub_rn(dp[nj][e], sr[r].z)) : 0.f;
          }
        uint32_t pk[4][2];
        pack(pk, sc, 1.f);
        put_tile(sm.ps, pk, t.r0(), t.c2);
        pack(pk, dp, sh.inv_scale);
        put_tile(sm.dss, pk, t.r0(), t.c2);
      }
    }
    __syncthreads();  // the pc and dss tiles are whole
    // phase B: dV and dK of keys 16 t.m.. over this query tile
    if (16 * t.m < kl)
      dkv_products(dva, dka, sm.ps, sm.dss, sm.gs, sm.qs, C::kStride,
                   ql > 16 ? 2 : 1, t.m, t.t0, t.lane);
  }
  if (16 * t.m < kl) {
    store_out(dv + k_at, hd, dva, kl, sh.dh, t.r0(), t.c2,
              t.t0, (sh.dh & 1) == 0);
    store_out(dk + k_at, hd, dka, kl, sh.dh, t.r0(), t.c2,
              t.t0, (sh.dh & 1) == 0);
  }
}

// ---- launch ----

// past 48 KB (DP = 256) a kernel must be allowed its dynamic shared memory
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// f(std::integral_constant<int, DP>) for the padded width DP of dh
template <typename F>
int with_padded(int dh, F&& f) {
  if (dh <= 16) return f(std::integral_constant<int, 16>{});
  if (dh <= 32) return f(std::integral_constant<int, 32>{});
  if (dh <= 64) return f(std::integral_constant<int, 64>{});
  if (dh <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

Shape shape(int n, int lq, int lk, int heads, int dh, double scale) {
  // 1/scale in double, rounded once to f32, as the other kernels
  return Shape{n, lq, lk, heads, dh, (float)(1.0 / scale), dh % 8 == 0};
}

bool bad(const Shape& sh) {
  return sh.n <= 0 || sh.lq <= 0 || sh.lk <= 0 || sh.heads <= 0 ||
         sh.dh <= 0 || sh.dh > 256;
}

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias,
               void* out, const Shape& sh, cudaStream_t st) {
  using C = Cfg<DP>;
  using T = __nv_bfloat16;
  const int err = allow_smem(wide_mma_fwd_kernel<DP>, C::kSmem);
  if (err) return err;
  const dim3 grid((unsigned)((long long)sh.n * sh.heads),
                  (unsigned)((sh.lq + kT - 1) / kT));
  wide_mma_fwd_kernel<DP><<<grid, C::kThreads, C::kSmem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out,
      sh);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const void* q, const void* k, const void* v, const void* bias,
               const void* g, void* dq, void* dk, void* dv, void* stats,
               void* ds, const Shape& sh, cudaStream_t st) {
  using C = Cfg<DP>;
  using T = __nv_bfloat16;
  const unsigned nh = (unsigned)((long long)sh.n * sh.heads);
  int err;
  if (sh.lq <= kT && sh.lk <= kT) {
    if ((err = allow_smem(wide_mma_bwd_kernel<DP>, C::kSmem))) return err;
    wide_mma_bwd_kernel<DP><<<nh, C::kThreads, C::kSmem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (T*)dq, (T*)dk, (T*)dv, (float*)ds, sh);
    return (int)cudaGetLastError();
  }
  if (stats == nullptr) return (int)cudaErrorInvalidValue;
  if ((err = allow_smem(wide_mma_bwd_dq_kernel<DP>, C::kSmem)) ||
      (err = allow_smem(wide_mma_bwd_dkv_kernel<DP>, C::kSmem)))
    return err;
  wide_mma_bwd_dq_kernel<DP>
      <<<dim3(nh, (sh.lq + kT - 1) / kT), C::kThreads, C::kSmem, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
          (const T*)g, (T*)dq, (float4*)stats, (float*)ds, sh);
  if ((err = (int)cudaGetLastError())) return err;
  wide_mma_bwd_dkv_kernel<DP>
      <<<dim3(nh, (sh.lk + kT - 1) / kT), C::kThreads, C::kSmem, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
          (const T*)g, (T*)dk, (T*)dv, (const float4*)stats, sh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: contiguous bf16 (N, Lq, heads*dh); k, v: (N, Lk, heads*dh); bias:
// contiguous f32 (N, Lq, Lk); all 16-byte aligned; any N, Lq, Lk and heads,
// dh from 1 to 256. Returns cudaGetLastError() after the launch (0 =
// success).
int deepsc_attention_wide_mma_fwd_bf16(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* out, int n, int lq, int lk,
                                       int heads, int dh, double scale,
                                       void* stream) {
  const Shape sh = shape(n, lq, lk, heads, dh, scale);
  if (bad(sh)) return (int)cudaErrorInvalidValue;
  return with_padded(dh, [&](auto dp) {
    return launch_fwd<decltype(dp)::value>(q, k, v, bias, out, sh,
                                           (cudaStream_t)stream);
  });
}

// As the forward, with g, dq shaped like q, dk and dv like k; dbias f32
// (N, Lq, Lk) or null; `stats` the caller's f32 scratch (N, heads, Lq, 4),
// 16-byte aligned, which past 32 queries or keys carries the softmax
// statistics from the dq kernel to the dk/dv kernel (else it may be null);
// `ds` the caller's f32 scratch (N, heads, Lq, Lk) for dbias (null without
// dbias).
int deepsc_attention_wide_mma_bwd_bf16(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* g, void* dq, void* dk,
                                       void* dv, void* dbias, void* stats,
                                       void* ds, int n, int lq, int lk,
                                       int heads, int dh, double scale,
                                       void* stream) {
  const Shape sh = shape(n, lq, lk, heads, dh, scale);
  if (bad(sh) || (dbias != nullptr) != (ds != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = with_padded(dh, [&](auto dp) {
    return launch_bwd<decltype(dp)::value>(q, k, v, bias, g, dq, dk, dv,
                                           stats, dbias ? ds : nullptr, sh,
                                           st);
  });
  if (err || dbias == nullptr) return err;
  return sum_dbias((const float*)ds, (float*)dbias, n, heads, lq, lk,
                   st);
}

}  // extern "C"
