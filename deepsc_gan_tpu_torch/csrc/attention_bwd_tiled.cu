// Fused multi-head attention backward (K2) in f32 at any head width and any
// number of heads, tiled for Hopper's CUDA cores (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `_bwd_kernel` of deepsc_gan_tpu/ops/pallas/
// attention.py where the narrow f32 kernels (csrc/attention_narrow.cu:
// heads of 8, 16 or 32, at most 16 of them) do not take the shape: the JAX
// kernel takes any head width and count, so `--dtype float32` with
// `--encoder-d-model 512` (8 heads of 64), a decoder of 8 heads of 25, 32
// heads of 16, one head of 512 or 2 heads of 320 run here, at any length
// (in bf16 those shapes take csrc/attention_wide_mma.cu and
// csrc/attention_chunked.cu; the f32 forward csrc/attention_tiled.cu).
// Same function and order of roundings as the plain version: with
// q (N, Lq, H*Dh), k and v (N, Lk, H*Dh), bias (N, Lq, Lk) f32 and g shaped
// like q,
//     s = (q_h . k_h) * (1/scale) + bias   (f32, two roundings)
//     p = exp(s - max) / sum               (f32)
//     dv = pc^T g with pc = p rounded to the input type (f32: p), dp = g v^T,
//     ds = p (dp - rowsum(dp p)),
//     dq = dss k, dk = dss^T q with dss = (ds * (1/scale)) rounded to the
//     input type (f32: as it is), dbias = sum_h ds (f32, heads in order
//     0..H-1),
// every product in exact f32 on the CUDA cores (no TF32).
//
// What bounds it: bytes. At N = 64, 2 heads of 320, Lq = Lk = 31 a call
// reads q, k, v, g and the bias and writes dq, dk and dv: 36.6 MB, 0.011
// ms at 3.35 TB/s (its 0.25 GFLOP take 0.004 ms at 67 TFLOP/s). The design
// before this one (csrc/attention_wide.cu: a warp per query, then per key,
// each running three passes over the other side with every logit a dot
// product of the head ended by five shuffles, and past 256-wide heads the
// accumulating pass run again per 256 columns) took 0.40-0.42 ms at the
// wide-heads path's shapes on an H100 80GB HBM3 at 700 W.
//
// Design, three kernels, each block of 128 threads (8 groups of 16):
// (1) block (batch row, head, tile of QT queries; QT = 32 (heads up to 32
//     wide), 16 or 8, the largest whose blocks fill the card twice):
//     S = q_t k^T and dP = g_t v^T, once: the (key chunk of KC, column
//     chunk of DC; DC = 32 for heads up to 32 wide, 128 for heads of 512
//     and more, else 64) pairs of q, g, k and v staged in order by
//     cp.async (16-byte copies where the head's width is a multiple of 4
//     floats) into two shared-memory stages, the next pair's copies in
//     flight while this one is multiplied, each logit and each dp a sum
//     over d in order 0..Dh-1 by fmaf; s scaled and its bias added; then a
//     warp a query row: the max, exp(s - max) and their sum, p = e / sum,
//     rowsum = sum_j p_j dp_j (lane l taking keys l, l + 32, ... in order
//     by fmaf, then a butterfly of five steps), ds and dss; p and dss go
//     to the caller's scratch (and ds too where dbias is asked for); then
//     dq = dss k, the (column chunk, key chunk of 32) pairs of k staged the
//     same way, each sum over the keys in order. S and dP stay in shared
//     memory where the row's keys fit (on an H100 up to about 700 to 3,000
//     keys by the tile), else they are formed in place in the scratch.
// (2) block (batch row, head, tile of KT keys; KT = 32, 16 or 8 as QT): dk =
//     dss^T q and dv = p^T g, the (column chunk, query chunk of 32) pairs of
//     q and g, with the tile's columns of p and dss from the scratch, staged
//     the same way; each sum over the queries in order. A head wider than
//     a chunk walks its column chunks without recomputing anything.
// (3) where dbias is asked for: dbias = sum over heads 0..H-1 of ds, an
//     element a thread.
// Every output element has one writer and a fixed order of sums: no
// atomics, the same bits on every call. The kernels allocate nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_stage.cuh"

namespace {

using cps::commit;
using cps::row_stride;
using cps::stage;
using cps::wait_group;

constexpr int kThreads = 128;  // 8 groups x 16 lanes
constexpr int kChunk = 32;     // keys (phase 3 of (1)) or queries ((2)) a
                               // staged chunk

struct Shape {
  int n, lq, lk, heads, dh;
  float inv_scale;
};

// floats of kernel (1)'s two stages (phase 1's q, g, k and v chunks, then
// phase 3's k chunks in the same space), and of an S or dP row of lk keys
// in shared memory (odd: the rows of a warp's queries fall in distinct
// banks)
__host__ __device__ constexpr int stage_floats(int qt, int kc, int dc) {
  return 2 * (2 * qt + 2 * kc) * row_stride(dc) >
                 2 * kChunk * row_stride(dc)
             ? 2 * (2 * qt + 2 * kc) * row_stride(dc)
             : 2 * kChunk * row_stride(dc);
}

__host__ __device__ constexpr int s_stride(int lk) { return lk | 1; }

// floats of kernel (2)'s two stages: q and g chunks of kChunk rows, and the
// p and dss columns of its KT keys for those rows
__host__ __device__ constexpr int kv_stage_floats(int kt, int dc) {
  return 2 * (2 * kChunk * row_stride(dc) + 2 * kChunk * kt);
}

// the output phases' layout at DC columns a chunk: L lanes a set of rows,
// each lane 4 columns (16 bytes) of every 4 L, and kThreads / L sets, each
// per_set of the tile's rows (at least one: sets past the tile are idle)
__host__ __device__ constexpr int lanes(int dc) {
  return dc < 64 ? dc / 4 : 16;
}

__host__ __device__ constexpr int per_set(int tile, int dc) {
  return tile > kThreads / lanes(dc) ? tile / (kThreads / lanes(dc)) : 1;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (1) S and dP of the tile's queries, the softmax, p, dss (and ds) into the
// scratch, and dq. p_out, dss_out, ds_out: the scratch's (N, H, Lq, Lk)
// arrays (ds_out null without dbias); in_place: S and dP formed in p_out
// and dss_out instead of shared memory.
template <int QT, int KC, int DC, bool kVec>
__global__ void __launch_bounds__(kThreads)
attention_bwd_tiled_dq_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ bias,
                              const float* __restrict__ g,
                              float* __restrict__ dq, float* __restrict__ p_out,
                              float* __restrict__ dss_out,
                              float* __restrict__ ds_out, bool in_place,
                              Shape sh) {
  constexpr int RQ = QT / 8;   // queries a thread in phase 1
  constexpr int KJ = KC / 16;  // keys a thread in phase 1
  constexpr int kDS = row_stride(DC);
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tg = tid >> 4;
  const int tl = tid & 15;
  const int qtiles = (sh.lq + QT - 1) / QT;
  const long long blk = blockIdx.x;
  const int q0 = (int)(blk % qtiles) * QT;
  const long long bh = blk / qtiles;
  const int h = (int)(bh % sh.heads);
  const long long b = bh / sh.heads;
  const int nq = min(QT, sh.lq - q0);
  const long long hd = (long long)sh.heads * sh.dh;
  const long long col = (long long)h * sh.dh;
  const float* qb = q + (b * sh.lq + q0) * hd + col;
  const float* gb = g + (b * sh.lq + q0) * hd + col;
  const float* kb = k + b * sh.lk * hd + col;
  const float* vb = v + b * sh.lk * hd + col;
  const float* bb = bias + (b * sh.lq + q0) * sh.lk;
  // this tile's rows of the scratch, at row stride lk
  const long long at = (bh * sh.lq + q0) * sh.lk;
  const int ss = in_place ? sh.lk : s_stride(sh.lk);
  float* S = in_place ? p_out + at : smem + stage_floats(QT, KC, DC);
  float* P = in_place ? dss_out + at : S + QT * ss;

  // (1a) S and dP: the stages walk (key chunk, column chunk) pairs in
  // order, the next pair's copies in flight while this one is multiplied
  float *qs[2], *gs[2], *ks[2], *vs[2];
  for (int s = 0; s < 2; ++s) {  // a stage: q and g (QT rows), k and v (KC)
    qs[s] = smem + s * (2 * QT + 2 * KC) * kDS;
    gs[s] = qs[s] + QT * kDS;
    ks[s] = gs[s] + QT * kDS;
    vs[s] = ks[s] + KC * kDS;
  }
  const int nd = (sh.dh + DC - 1) / DC;
  const int nkc = (sh.lk + KC - 1) / KC;
  const auto issue1 = [&](int t) {
    const int kc0 = (t / nd) * KC, d0 = (t % nd) * DC;
    stage<kThreads, kVec>(qs[t & 1], kDS, qb + d0, hd, QT, DC, nq, sh.dh - d0);
    stage<kThreads, kVec>(gs[t & 1], kDS, gb + d0, hd, QT, DC, nq, sh.dh - d0);
    stage<kThreads, kVec>(ks[t & 1], kDS, kb + kc0 * hd + d0, hd, KC, DC,
                          sh.lk - kc0, sh.dh - d0);
    stage<kThreads, kVec>(vs[t & 1], kDS, vb + kc0 * hd + d0, hd, KC, DC,
                          sh.lk - kc0, sh.dh - d0);
    commit();
  };
  float acc[RQ][KJ], accp[RQ][KJ];
  issue1(0);
  for (int t = 0; t < nkc * nd; ++t) {
    if (t % nd == 0) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) acc[i][j] = accp[i][j] = 0.f;
    }
    if (t + 1 < nkc * nd) {
      issue1(t + 1);
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    const float* qa = qs[t & 1];
    const float* ga = gs[t & 1];
    const float* ka = ks[t & 1];
    const float* va = vs[t & 1];
#pragma unroll 2
    for (int d = 0; d < DC; d += 4) {  // columns past Dh are zeros
      float4 a[RQ], c[RQ], x[KJ], y[KJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        a[i] = *reinterpret_cast<const float4*>(qa + (tg * RQ + i) * kDS + d);
        c[i] = *reinterpret_cast<const float4*>(ga + (tg * RQ + i) * kDS + d);
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        x[j] = *reinterpret_cast<const float4*>(ka + (tl + 16 * j) * kDS + d);
        y[j] = *reinterpret_cast<const float4*>(va + (tl + 16 * j) * kDS + d);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          acc[i][j] = fmaf(a[i].x, x[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, x[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, x[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, x[j].w, acc[i][j]);
          accp[i][j] = fmaf(c[i].x, y[j].x, accp[i][j]);
          accp[i][j] = fmaf(c[i].y, y[j].y, accp[i][j]);
          accp[i][j] = fmaf(c[i].z, y[j].z, accp[i][j]);
          accp[i][j] = fmaf(c[i].w, y[j].w, accp[i][j]);
        }
    }
    __syncthreads();  // the stage is free for the pair after next
    if (t % nd == nd - 1) {
      const int kc0 = (t / nd) * KC;
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qi = tg * RQ + i;
        if (qi >= nq) continue;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int kj = kc0 + tl + 16 * j;
          if (kj < sh.lk) {
            S[qi * ss + kj] =
                __fadd_rn(__fmul_rn(acc[i][j], sh.inv_scale),
                          __ldg(bb + (long long)qi * sh.lk + kj));
            P[qi * ss + kj] = accp[i][j];
          }
        }
      }
    }
  }
  __syncthreads();

  // (1b) a warp a query row: p, rowsum, ds and dss (in place of S and dP);
  // p, dss and ds to the scratch
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int r = warp; r < nq; r += kThreads / 32) {
    float* srow = S + r * ss;
    float* prow = P + r * ss;
    float m = -INFINITY;
    for (int j = lane; j < sh.lk; j += 32) m = fmaxf(m, srow[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < sh.lk; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float racc = 0.f;
    for (int j = lane; j < sh.lk; j += 32) {
      const float p = __fdiv_rn(srow[j], sum);
      srow[j] = p;
      racc = fmaf(p, prow[j], racc);
    }
    const float rowsum = warp_sum(racc);
    const long long out = at + (long long)r * sh.lk;
    for (int j = lane; j < sh.lk; j += 32) {
      const float ds = __fmul_rn(srow[j], __fsub_rn(prow[j], rowsum));
      const float dss = __fmul_rn(ds, sh.inv_scale);
      prow[j] = dss;
      if (ds_out != nullptr) ds_out[out + j] = ds;
      if (!in_place) {
        p_out[out + j] = srow[j];
        dss_out[out + j] = dss;
      }
    }
  }
  __syncthreads();

  // (1c) dq = dss k: the stages walk (column chunk, key chunk) pairs in
  // order; thread (set, l) sums queries set R3 .. set R3 + R3 - 1 at
  // columns 4 l + 4 L c .. + 3 (c < CQ) of the chunk
  constexpr int L = lanes(DC), R3 = per_set(QT, DC), CQ = DC / (4 * L);
  const int qset = tid / L, cl = tid % L;
  float* kv[2] = {smem, smem + kChunk * kDS};
  const int nkv = (sh.lk + kChunk - 1) / kChunk;
  const int ncc = (sh.dh + DC - 1) / DC;
  const auto issue3 = [&](int t) {
    const int c0 = (t / nkv) * DC, j0 = (t % nkv) * kChunk;
    stage<kThreads, kVec>(kv[t & 1], kDS, kb + j0 * hd + c0, hd, kChunk, DC,
                          sh.lk - j0, sh.dh - c0);
    commit();
  };
  float* ob = dq + (b * sh.lq + q0) * hd + col;
  float o[R3][CQ][4];
  issue3(0);
  for (int t = 0; t < ncc * nkv; ++t) {
    if (t % nkv == 0) {
#pragma unroll
      for (int i = 0; i < R3; ++i)
#pragma unroll
        for (int c = 0; c < CQ; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
    }
    if (t + 1 < ncc * nkv) {
      issue3(t + 1);
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    const float* ka = kv[t & 1];
    const int j0 = (t % nkv) * kChunk;
    const int cnt = min(kChunk, sh.lk - j0);
    for (int j = 0; j < cnt; ++j) {
      float w[R3];
#pragma unroll
      for (int i = 0; i < R3; ++i)  // rows past nq: not this tile's
        w[i] = qset * R3 + i < nq ? P[(qset * R3 + i) * ss + j0 + j] : 0.f;
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(
            ka + j * kDS + 4 * L * c + 4 * cl);
#pragma unroll
        for (int i = 0; i < R3; ++i) {
          o[i][c][0] = fmaf(w[i], x.x, o[i][c][0]);
          o[i][c][1] = fmaf(w[i], x.y, o[i][c][1]);
          o[i][c][2] = fmaf(w[i], x.z, o[i][c][2]);
          o[i][c][3] = fmaf(w[i], x.w, o[i][c][3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the pair after next
    if (t % nkv == nkv - 1) {
#pragma unroll
      for (int i = 0; i < R3; ++i) {
        const int qi = qset * R3 + i;
        if (qi >= nq) continue;
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const int cc = (t / nkv) * DC + 4 * L * c + 4 * cl;
          float* dst = ob + qi * hd + cc;
          if (kVec && cc < sh.dh) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(o[i][c][0], o[i][c][1], o[i][c][2], o[i][c][3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (cc + e < sh.dh) dst[e] = o[i][c][e];
          }
        }
      }
    }
  }
}

// (2) dk = dss^T q and dv = p^T g for the tile's keys: the stages walk
// (column chunk, query chunk) pairs in order; thread (set, l) sums keys
// set RK .. set RK + RK - 1 at columns 4 l + 4 L c .. + 3 (c < CQ) of the
// chunk
template <int KT, int DC, bool kVec>
__global__ void __launch_bounds__(kThreads)
attention_bwd_tiled_dkv_kernel(const float* __restrict__ q,
                               const float* __restrict__ g,
                               const float* __restrict__ p_in,
                               const float* __restrict__ dss_in,
                               float* __restrict__ dk,
                               float* __restrict__ dv, Shape sh) {
  constexpr int L = lanes(DC), RK = per_set(KT, DC), CQ = DC / (4 * L);
  constexpr int kDS = row_stride(DC);
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int kset = tid / L, cl = tid % L;
  const int ktiles = (sh.lk + KT - 1) / KT;
  const long long blk = blockIdx.x;
  const int k0 = (int)(blk % ktiles) * KT;
  const long long bh = blk / ktiles;
  const int h = (int)(bh % sh.heads);
  const long long b = bh / sh.heads;
  const int nk = min(KT, sh.lk - k0);
  const long long hd = (long long)sh.heads * sh.dh;
  const long long col = (long long)h * sh.dh;
  const float* qb = q + b * sh.lq * hd + col;
  const float* gb = g + b * sh.lq * hd + col;
  const float* pb = p_in + bh * sh.lq * sh.lk + k0;
  const float* db = dss_in + bh * sh.lq * sh.lk + k0;

  const int stage_size = kv_stage_floats(KT, DC) / 2;
  float* qs[2] = {smem, smem + stage_size};
  float* gs[2] = {qs[0] + kChunk * kDS, qs[1] + kChunk * kDS};
  float* ps[2] = {gs[0] + kChunk * kDS, gs[1] + kChunk * kDS};
  float* ws[2] = {ps[0] + kChunk * KT, ps[1] + kChunk * KT};
  const int nqc = (sh.lq + kChunk - 1) / kChunk;
  const int ncc = (sh.dh + DC - 1) / DC;
  const auto issue = [&](int t) {
    const int c0 = (t / nqc) * DC, i0 = (t % nqc) * kChunk;
    stage<kThreads, kVec>(qs[t & 1], kDS, qb + i0 * hd + c0, hd, kChunk, DC,
                          sh.lq - i0, sh.dh - c0);
    stage<kThreads, kVec>(gs[t & 1], kDS, gb + i0 * hd + c0, hd, kChunk, DC,
                          sh.lq - i0, sh.dh - c0);
    stage<kThreads, false>(ps[t & 1], KT, pb + (long long)i0 * sh.lk,
                           sh.lk, kChunk, KT, sh.lq - i0, nk);
    stage<kThreads, false>(ws[t & 1], KT, db + (long long)i0 * sh.lk,
                           sh.lk, kChunk, KT, sh.lq - i0, nk);
    commit();
  };
  float* dkb = dk + (b * sh.lk + k0) * hd + col;
  float* dvb = dv + (b * sh.lk + k0) * hd + col;
  float ak[RK][CQ][4], av[RK][CQ][4];
  issue(0);
  for (int t = 0; t < ncc * nqc; ++t) {
    if (t % nqc == 0) {
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int c = 0; c < CQ; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) ak[r][c][e] = av[r][c][e] = 0.f;
    }
    if (t + 1 < ncc * nqc) {
      issue(t + 1);
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    const float* qa = qs[t & 1];
    const float* ga = gs[t & 1];
    const float* pa = ps[t & 1];
    const float* wa = ws[t & 1];
    const int i0 = (t % nqc) * kChunk;
    const int cnt = min(kChunk, sh.lq - i0);
    for (int i = 0; i < cnt; ++i) {
      float pw[RK], dw[RK];
#pragma unroll
      for (int r = 0; r < RK; ++r) {  // sets past the tile's keys: idle
        const int kj = min(kset * RK + r, KT - 1);
        pw[r] = pa[i * KT + kj];
        dw[r] = wa[i * KT + kj];
      }
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(
            qa + i * kDS + 4 * L * c + 4 * cl);
        const float4 y = *reinterpret_cast<const float4*>(
            ga + i * kDS + 4 * L * c + 4 * cl);
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          ak[r][c][0] = fmaf(dw[r], x.x, ak[r][c][0]);
          ak[r][c][1] = fmaf(dw[r], x.y, ak[r][c][1]);
          ak[r][c][2] = fmaf(dw[r], x.z, ak[r][c][2]);
          ak[r][c][3] = fmaf(dw[r], x.w, ak[r][c][3]);
          av[r][c][0] = fmaf(pw[r], y.x, av[r][c][0]);
          av[r][c][1] = fmaf(pw[r], y.y, av[r][c][1]);
          av[r][c][2] = fmaf(pw[r], y.z, av[r][c][2]);
          av[r][c][3] = fmaf(pw[r], y.w, av[r][c][3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the pair after next
    if (t % nqc == nqc - 1) {
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        const int kj = kset * RK + r;
        if (kj >= nk) continue;
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const int cc = (t / nqc) * DC + 4 * L * c + 4 * cl;
          float* dkd = dkb + kj * hd + cc;
          float* dvd = dvb + kj * hd + cc;
          if (kVec && cc < sh.dh) {
            *reinterpret_cast<float4*>(dkd) = make_float4(
                ak[r][c][0], ak[r][c][1], ak[r][c][2], ak[r][c][3]);
            *reinterpret_cast<float4*>(dvd) = make_float4(
                av[r][c][0], av[r][c][1], av[r][c][2], av[r][c][3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (cc + e < sh.dh) {
                dkd[e] = ak[r][c][e];
                dvd[e] = av[r][c][e];
              }
          }
        }
      }
    }
  }
}

// (3) dbias = sum over heads 0..H-1 of ds: an element a thread
__global__ void attention_bwd_tiled_dbias_kernel(const float* __restrict__ ds,
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

// head columns a stage holds: 128 for heads of 512 or more (half the
// stages a block), 32 for heads up to 32 wide (half the padding, twice the
// blocks an SM of 64), else 64
int column_chunk(const Shape& sh) {
  return sh.dh >= 512 ? 128 : sh.dh <= 32 ? 32 : 64;
}

// the tile of queries (or keys) a block: the largest of 32 (heads up to 32
// wide; wider, the tiles of 32 ran slower on an H100), 16 and 8 whose
// blocks are at least two for each SM of the current device (8 if none)
int tile(const Shape& sh, int length, int* out) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  *out = 8;
  for (int t = column_chunk(sh) == 32 ? 32 : 16; t > 8; t /= 2)
    if ((long long)sh.n * sh.heads * ((length + t - 1) / t) >= 2LL * sms) {
      *out = t;
      break;
    }
  return 0;
}

// keys of an S chunk of phase (1a): 32 (two a thread) up to 32 keys or at
// heads of 512 and more (their stages hold 128 columns), else 64
int key_chunk(const Shape& sh) {
  return sh.lk <= 32 || sh.dh >= 512 ? 32 : 64;
}


size_t dq_smem_bytes(int qt, int kc, int dc, int lk, bool s_shared) {
  return sizeof(float) * ((size_t)stage_floats(qt, kc, dc) +
                          (s_shared ? 2 * (size_t)qt * s_stride(lk) : 0));
}

// whether S and dP are formed in the scratch (they do not fit a block's
// shared memory beside the stages)
int in_place(const Shape& sh, int qt, bool* out) {
  int dev = 0, optin = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  *out = dq_smem_bytes(qt, key_chunk(sh), column_chunk(sh), sh.lk, true) >
         (size_t)optin;
  return 0;
}

bool bad(const Shape& sh) {
  return sh.n <= 0 || sh.lq <= 0 || sh.lk <= 0 || sh.heads <= 0 ||
         sh.dh <= 0;
}

Shape shape(int n, int lq, int lk, int heads, int dh, double scale) {
  // 1/scale in double, rounded once to f32, as the other K2 kernels
  return Shape{n, lq, lk, heads, dh, (float)(1.0 / scale)};
}

struct Args {
  const float *q, *k, *v, *bias, *g;
  float *dq, *dk, *dv, *dbias, *p, *dss, *ds;
};

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int QT, int KC, int DC, bool kVec>
int launch_dq(const Args& a, bool place, const Shape& sh, cudaStream_t st) {
  const size_t smem = dq_smem_bytes(QT, KC, DC, sh.lk, !place);
  const auto kernel = attention_bwd_tiled_dq_kernel<QT, KC, DC, kVec>;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const long long blocks =
      (long long)sh.n * sh.heads * ((sh.lq + QT - 1) / QT);
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      a.q, a.k, a.v, a.bias, a.g, a.dq, a.p, a.dss, a.ds, place, sh);
  return (int)cudaGetLastError();
}

template <int KT, int DC, bool kVec>
int launch_dkv(const Args& a, const Shape& sh, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)kv_stage_floats(KT, DC);
  const auto kernel = attention_bwd_tiled_dkv_kernel<KT, DC, kVec>;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const long long blocks =
      (long long)sh.n * sh.heads * ((sh.lk + KT - 1) / KT);
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(a.q, a.g, a.p, a.dss,
                                                   a.dk, a.dv, sh);
  return (int)cudaGetLastError();
}

// kernel (1) for the query tile, key chunk, column chunk and copy width
template <int DC, bool kVec>
int dq_for(int qt, int kc, const Args& a, bool place, const Shape& sh,
           cudaStream_t st) {
  if (qt == 32)
    return kc == 32 ? launch_dq<32, 32, DC, kVec>(a, place, sh, st)
                    : launch_dq<32, 64, DC, kVec>(a, place, sh, st);
  if (qt == 16)
    return kc == 32 ? launch_dq<16, 32, DC, kVec>(a, place, sh, st)
                    : launch_dq<16, 64, DC, kVec>(a, place, sh, st);
  return kc == 32 ? launch_dq<8, 32, DC, kVec>(a, place, sh, st)
                  : launch_dq<8, 64, DC, kVec>(a, place, sh, st);
}

template <int DC, bool kVec>
int dkv_for(int kt, const Args& a, const Shape& sh, cudaStream_t st) {
  return kt == 32   ? launch_dkv<32, DC, kVec>(a, sh, st)
         : kt == 16 ? launch_dkv<16, DC, kVec>(a, sh, st)
                    : launch_dkv<8, DC, kVec>(a, sh, st);
}

int launch(const Args& a, const Shape& sh, cudaStream_t st) {
  int qt = 16, kt = 16;
  bool place = false;
  int err = tile(sh, sh.lq, &qt);
  if (!err) err = tile(sh, sh.lk, &kt);
  if (!err) err = in_place(sh, qt, &place);
  if (err) return err;
  // 16-byte copies where every row of a head starts on 16 bytes
  const bool vec = sh.dh % 4 == 0 &&
                   ((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                    (uintptr_t)a.g | (uintptr_t)a.dq | (uintptr_t)a.dk |
                    (uintptr_t)a.dv) % 16 == 0;
  const int kc = key_chunk(sh);
  const int dc = column_chunk(sh);
  if (dc == 32)
    err = vec ? dq_for<32, true>(qt, kc, a, place, sh, st)
              : dq_for<32, false>(qt, kc, a, place, sh, st);
  else if (dc == 64)
    err = vec ? dq_for<64, true>(qt, kc, a, place, sh, st)
              : dq_for<64, false>(qt, kc, a, place, sh, st);
  else
    err = vec ? dq_for<128, true>(qt, kc, a, place, sh, st)
              : dq_for<128, false>(qt, kc, a, place, sh, st);
  if (err) return err;
  if (dc == 32)
    err = vec ? dkv_for<32, true>(kt, a, sh, st)
              : dkv_for<32, false>(kt, a, sh, st);
  else if (dc == 64)
    err = vec ? dkv_for<64, true>(kt, a, sh, st)
              : dkv_for<64, false>(kt, a, sh, st);
  else
    err = vec ? dkv_for<128, true>(kt, a, sh, st)
              : dkv_for<128, false>(kt, a, sh, st);
  if (err || a.dbias == nullptr) return err;
  const long long total = (long long)sh.n * sh.lq * sh.lk;
  attention_bwd_tiled_dbias_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                     st>>>(a.ds, a.dbias, sh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, g, dq: contiguous f32 (N, Lq, heads*dh); k, v, dk, dv: (N, Lk,
// heads*dh); bias: contiguous f32 (N, Lq, Lk); dbias f32 (N, Lq, Lk) or
// null; `scratch` the caller's f32 scratch of 2 N heads Lq Lk floats (p,
// then dss), 3 N heads Lq Lk with dbias (ds after them); any N, Lq, Lk,
// heads and dh >= 1. Returns cudaGetLastError() after the launches (0 =
// success).
int deepsc_attention_bwd_tiled_f32(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* g, void* dq, void* dk,
                                   void* dv, void* dbias, void* scratch,
                                   int n, int lq, int lk, int heads, int dh,
                                   double scale, void* stream) {
  const Shape sh = shape(n, lq, lk, heads, dh, scale);
  if (bad(sh) || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t per = (size_t)n * heads * lq * lk;
  float* s = (float*)scratch;
  const Args a{(const float*)q, (const float*)k,     (const float*)v,
               (const float*)bias, (const float*)g,  (float*)dq,
               (float*)dk,        (float*)dv,        (float*)dbias,
               s,                 s + per,           dbias ? s + 2 * per
                                                           : nullptr};
  return launch(a, sh, (cudaStream_t)stream);
}

}  // extern "C"
