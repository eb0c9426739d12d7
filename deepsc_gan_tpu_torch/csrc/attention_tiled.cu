// Fused multi-head attention forward (K1) in f32 at any head width and any
// number of heads, tiled for Hopper's CUDA cores (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `_fwd_kernel` of deepsc_gan_tpu/ops/pallas/
// attention.py where the narrow f32 kernel (csrc/attention_narrow.cu:
// heads of 8, 16 or 32, at most 16 of them) does not take the shape: the JAX
// kernel takes any head width and count, so `--dtype float32` with
// `--encoder-d-model 512` (8 heads of 64), a decoder of 8 heads of 25, 32
// heads of 16, one head of 512 or 2 heads of 320 run here (in bf16 those
// shapes take csrc/attention_wide_mma.cu and csrc/attention_chunked.cu).
// Same function and roundings as the plain version: with q (N, Lq, H*Dh),
// k and v (N, Lk, H*Dh) and bias (N, Lq, Lk) f32,
//     s = (q_h . k_h) * (1/scale) + bias   (f32, two roundings)
//     p = exp(s - max) / sum               (an exact softmax, f32)
//     out = p v_h                          (f32 sums)
// every product in exact f32 on the CUDA cores (no TF32).
//
// What bounds it: bytes. At N = 64, one head of 512, Lq = Lk = 32 a call
// reads q, k, v and the bias and writes out: 17.0 MB, 0.0051 ms at 3.35
// TB/s (its 0.27 GFLOP take 0.004 ms at 67 TFLOP/s). The design before
// this one (csrc/attention_wide.cu: a warp per query, three passes over
// the keys, each logit a dot product of the head ended by five shuffles,
// K and V read once per query, and past 256-wide heads the last pass run
// again per 256 columns) took 0.127-0.165 ms at the wide-heads path's
// shapes on an H100 80GB HBM3 at 700 W.
//
// Design: a block of 128 threads per (batch row, head, tile of QT queries;
// QT = 16, or 8 where the blocks of 16 would not fill the card twice):
// (1) S = q_t k^T for the tile, once: the keys in chunks of KC (32 where
//     the row has at most 32 keys, else 64), for each chunk the head's
//     columns in chunks of DC (64, or 128 for heads of 512 or more: half
//     the stages a block); the (key chunk, column chunk) pairs are
//     staged in order by cp.async (16-byte copies where the head's width
//     is a multiple of 4 floats) into two shared-memory stages, the next
//     pair's copies in flight while this one is multiplied; thread (g, l)
//     sums queries g QT/8 .. and keys l + 16 j (j < KC/16) over d in order
//     0..Dh-1 by fmaf, four columns a 16-byte read; each logit scaled, its
//     bias (read once) added, and kept in shared memory (or, for rows of
//     keys too long for it, in a caller's scratch);
// (2) a warp per query row: the max, then exp(s - max) and their sum, then
//     p = e / sum in place;
// (3) out = p v: the (column chunk of DC, key chunk of 32) pairs staged in
//     order the same way (a head past 256 walks its column chunks without
//     recomputing S), thread (g, l) summing queries g QT/8 .. at columns
//     4 l + 64 c .. 4 l + 64 c + 3 of the chunk over the keys in order.
// Every output element has one writer and a fixed order of sums: the same
// bits on every call. The kernel allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_stage.cuh"

namespace {

using cps::commit;
using cps::row_stride;
using cps::stage;
using cps::wait_group;

constexpr int kThreads = 128;  // 8 query groups x 16 lanes
constexpr int kKV = 32;        // keys of a staged v chunk

struct Shape {
  int n, lq, lk, heads, dh;
  float inv_scale;
};

// floats of the two stages (phase 1's q and k chunks, then phase 3's v
// chunks in the same space), and of an S row of lk keys (odd: the rows
// of a warp's queries fall in distinct banks)
__host__ __device__ constexpr int stage_floats(int qt, int kc, int dc) {
  return 2 * (qt + kc) * row_stride(dc) > 2 * kKV * row_stride(dc)
             ? 2 * (qt + kc) * row_stride(dc)
             : 2 * kKV * row_stride(dc);
}

__host__ __device__ constexpr int s_stride(int lk) { return lk | 1; }


template <int QT, int KC, int DC, bool kVec>
__global__ void __launch_bounds__(kThreads)
attention_fwd_tiled_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ bias,
                           float* __restrict__ out, float* __restrict__ s_out,
                           Shape sh) {
  constexpr int RQ = QT / 8;   // queries a thread
  constexpr int KJ = KC / 16;  // keys a thread in phase 1
  constexpr int CQ = DC / 64;  // 16-byte column groups a thread in phase 3
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
  const float* qb = q + (b * sh.lq + q0) * hd + (long long)h * sh.dh;
  const float* kb = k + b * sh.lk * hd + (long long)h * sh.dh;
  const float* vb = v + b * sh.lk * hd + (long long)h * sh.dh;
  const float* bb = bias + (b * sh.lq + q0) * sh.lk;
  const int ss = s_stride(sh.lk);
  float* S = s_out != nullptr ? s_out + blk * QT * ss
                              : smem + stage_floats(QT, KC, DC);

  // (1) the logits: the stages walk (key chunk, column chunk) pairs in
  // order, the next pair's copies in flight while this one is multiplied
  float* qs[2] = {smem, smem + QT * kDS};
  float* ks[2] = {smem + 2 * QT * kDS, smem + 2 * QT * kDS + KC * kDS};
  const int nd = (sh.dh + DC - 1) / DC;
  const int nkc = (sh.lk + KC - 1) / KC;
  const auto issue1 = [&](int t) {
    const int kc0 = (t / nd) * KC, d0 = (t % nd) * DC;
    stage<kThreads, kVec>(qs[t & 1], kDS, qb + d0, hd, QT, DC, nq, sh.dh - d0);
    stage<kThreads, kVec>(ks[t & 1], kDS, kb + kc0 * hd + d0, hd, KC, DC,
                          sh.lk - kc0, sh.dh - d0);
    commit();
  };
  float acc[RQ][KJ];
  issue1(0);
  for (int t = 0; t < nkc * nd; ++t) {
    if (t % nd == 0) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
    }
    if (t + 1 < nkc * nd) {
      issue1(t + 1);
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    const float* qa = qs[t & 1];
    const float* ka = ks[t & 1];
#pragma unroll 4
    for (int d = 0; d < DC; d += 4) {  // columns past Dh are zeros
      float4 a[RQ], x[KJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        a[i] = *reinterpret_cast<const float4*>(qa + (tg * RQ + i) * kDS + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        x[j] = *reinterpret_cast<const float4*>(ka + (tl + 16 * j) * kDS + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          acc[i][j] = fmaf(a[i].x, x[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, x[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, x[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, x[j].w, acc[i][j]);
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
          if (kj < sh.lk)
            S[qi * ss + kj] =
                __fadd_rn(__fmul_rn(acc[i][j], sh.inv_scale),
                          __ldg(bb + (long long)qi * sh.lk + kj));
        }
      }
    }
  }
  __syncthreads();

  // (2) the softmax of each query row, a warp a row
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int r = warp; r < nq; r += kThreads / 32) {
    float* row = S + r * ss;
    float m = -INFINITY;
    for (int j = lane; j < sh.lk; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < sh.lk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < sh.lk; j += 32) row[j] = __fdiv_rn(row[j], sum);
  }
  __syncthreads();

  // (3) out = p v: the stages walk (column chunk, key chunk) pairs in
  // order; thread (g, l) sums columns 4 l + 64 c .. 4 l + 64 c + 3 (c <
  // CQ) of the chunk
  float* vs[2] = {smem, smem + kKV * kDS};
  const int nkv = (sh.lk + kKV - 1) / kKV;
  const int ncc = (sh.dh + DC - 1) / DC;
  const auto issue3 = [&](int t) {
    const int c0 = (t / nkv) * DC, j0 = (t % nkv) * kKV;
    stage<kThreads, kVec>(vs[t & 1], kDS, vb + j0 * hd + c0, hd, kKV, DC,
                          sh.lk - j0, sh.dh - c0);
    commit();
  };
  float* ob = out + (b * sh.lq + q0) * hd + (long long)h * sh.dh;
  float o[RQ][CQ][4];
  issue3(0);
  for (int t = 0; t < ncc * nkv; ++t) {
    if (t % nkv == 0) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int g = 0; g < CQ; ++g)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[i][g][c] = 0.f;
    }
    if (t + 1 < ncc * nkv) {
      issue3(t + 1);
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    const float* va = vs[t & 1];
    const int j0 = (t % nkv) * kKV;
    const int cnt = min(kKV, sh.lk - j0);
    for (int j = 0; j < cnt; ++j) {
      float p[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = S[(tg * RQ + i) * ss + j0 + j];
#pragma unroll
      for (int g = 0; g < CQ; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(
            va + j * kDS + 64 * g + 4 * tl);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          o[i][g][0] = fmaf(p[i], x.x, o[i][g][0]);
          o[i][g][1] = fmaf(p[i], x.y, o[i][g][1]);
          o[i][g][2] = fmaf(p[i], x.z, o[i][g][2]);
          o[i][g][3] = fmaf(p[i], x.w, o[i][g][3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the pair after next
    if (t % nkv == nkv - 1) {
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qi = tg * RQ + i;
        if (qi >= nq) continue;
#pragma unroll
        for (int g = 0; g < CQ; ++g) {
          const int col = (t / nkv) * DC + 64 * g + 4 * tl;
          float* dst = ob + qi * hd + col;
          if (kVec && col < sh.dh) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(o[i][g][0], o[i][g][1], o[i][g][2], o[i][g][3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (col + c < sh.dh) dst[c] = o[i][g][c];
          }
        }
      }
    }
  }
}

// queries a block: 16, or 8 where blocks of 16 would be fewer than two
// for each SM of the current device
int query_tile(const Shape& sh, int* qt) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  const long long blocks16 =
      (long long)sh.n * sh.heads * ((sh.lq + 15) / 16);
  *qt = blocks16 >= 2LL * sms ? 16 : 8;
  return 0;
}

// keys of an S chunk of phase 1: 32 (two a thread) up to 32 keys, else 64
int key_chunk(const Shape& sh) { return sh.lk <= 32 ? 32 : 64; }

// head columns a stage holds: 128 for heads of 512 or more (half the
// stages a block), else 64 (a head of 128 in one stage of 128 has nothing
// to overlap its copies with, and one of 320 padded to 384 does a fifth
// more work: both ran slower on an H100 with stages of 128)
int column_chunk(const Shape& sh) { return sh.dh >= 512 ? 128 : 64; }

long long blocks(const Shape& sh, int qt) {
  return (long long)sh.n * sh.heads * ((sh.lq + qt - 1) / qt);
}

// bytes of a block's shared memory: the stages, and S where it is not in
// the scratch
size_t smem_bytes(int qt, int kc, int dc, int lk, bool s_shared) {
  return sizeof(float) * ((size_t)stage_floats(qt, kc, dc) +
                          (s_shared ? (size_t)qt * s_stride(lk) : 0));
}

// S's scratch floats (0 where S fits a block's shared memory)
int scratch_floats(const Shape& sh, int qt, size_t* out) {
  int dev = 0, optin = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  *out = smem_bytes(qt, key_chunk(sh), column_chunk(sh), sh.lk, true) <=
                 (size_t)optin
             ? 0
             : (size_t)blocks(sh, qt) * qt * s_stride(sh.lk);
  return 0;
}

bool bad(const Shape& sh) {
  return sh.n <= 0 || sh.lq <= 0 || sh.lk <= 0 || sh.heads <= 0 ||
         sh.dh <= 0;
}

Shape shape(int n, int lq, int lk, int heads, int dh, double scale) {
  // 1/scale in double, rounded once to f32, as the other K1 kernels
  return Shape{n, lq, lk, heads, dh, (float)(1.0 / scale)};
}

template <int QT, int KC, int DC, bool kVec>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, float* s_out, const Shape& sh, cudaStream_t st) {
  const size_t smem = smem_bytes(QT, KC, DC, sh.lk, s_out == nullptr);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        attention_fwd_tiled_kernel<QT, KC, DC, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  attention_fwd_tiled_kernel<QT, KC, DC, kVec>
      <<<(unsigned)blocks(sh, QT), kThreads, smem, st>>>(
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)bias, (float*)out, s_out, sh);
  return (int)cudaGetLastError();
}

// the kernel for the column chunk and copy width, at a query tile and key
// chunk
template <int QT, int KC>
int launch_chunks(bool vec, const void* q, const void* k, const void* v,
                  const void* bias, void* out, float* s_out, const Shape& sh,
                  cudaStream_t st) {
  if (column_chunk(sh) == 64)
    return vec ? launch<QT, KC, 64, true>(q, k, v, bias, out, s_out, sh, st)
               : launch<QT, KC, 64, false>(q, k, v, bias, out, s_out, sh, st);
  return vec ? launch<QT, KC, 128, true>(q, k, v, bias, out, s_out, sh, st)
             : launch<QT, KC, 128, false>(q, k, v, bias, out, s_out, sh, st);
}

}  // namespace

extern "C" {

// f32 floats of the scratch that deepsc_attention_tiled_fwd_f32 needs for
// these shapes: 0 where a block's logits fit its shared memory (on an H100
// up to 2,300 to 6,000 keys by the tile), else a row of the logits a query
// of each block.
// Returns 0, or a CUDA error.
int deepsc_attention_tiled_scratch_f32(int n, int lq, int lk, int heads,
                                       int dh, long long* out) {
  const Shape sh = shape(n, lq, lk, heads, dh, 1.0);
  if (bad(sh)) return (int)cudaErrorInvalidValue;
  int qt = 16;
  int err = query_tile(sh, &qt);
  size_t floats = 0;
  if (!err) err = scratch_floats(sh, qt, &floats);
  *out = (long long)floats;
  return err;
}

// q, out: contiguous f32 (N, Lq, heads*dh); k, v: (N, Lk, heads*dh); bias:
// contiguous f32 (N, Lq, Lk); any N, Lq, Lk, heads and dh >= 1. scratch:
// f32 of deepsc_attention_tiled_scratch_f32's floats, or null where that is
// 0. Returns cudaGetLastError() after the launch (0 = success).
int deepsc_attention_tiled_fwd_f32(const void* q, const void* k,
                                   const void* v, const void* bias, void* out,
                                   void* scratch, int n, int lq, int lk,
                                   int heads, int dh, double scale,
                                   void* stream) {
  const Shape sh = shape(n, lq, lk, heads, dh, scale);
  if (bad(sh)) return (int)cudaErrorInvalidValue;
  int qt = 16;
  int err = query_tile(sh, &qt);
  size_t floats = 0;
  if (!err) err = scratch_floats(sh, qt, &floats);
  if (err) return err;
  if (floats > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  float* s_out = floats > 0 ? (float*)scratch : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  // 16-byte copies where every row of a head starts on 16 bytes
  const bool vec = dh % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (key_chunk(sh) == 32)
    return qt == 16
               ? launch_chunks<16, 32>(vec, q, k, v, bias, out, s_out, sh, st)
               : launch_chunks<8, 32>(vec, q, k, v, bias, out, s_out, sh, st);
  return qt == 16
             ? launch_chunks<16, 64>(vec, q, k, v, bias, out, s_out, sh, st)
             : launch_chunks<8, 64>(vec, q, k, v, bias, out, s_out, sh, st);
}

}  // extern "C"
