// Fused multi-head attention, forward and backward, for heads wider than
// 256, bf16, on Hopper's tensor cores (mma.sync, sm_90a), plain C
// interface.
//
// Replaces the TPU kernels `_fwd_kernel` (K1; the backward below replaces
// `_bwd_kernel`, K2) of deepsc_gan_tpu/ops/pallas/attention.py where the
// tuned kernels (csrc/attention_fwd.cu, csrc/attention_bwd.cu: heads of 8,
// 16 or 32) and the tensor-core wide kernels (csrc/attention_wide_mma.cu:
// heads up to 256) do not take the width: the wide-heads model's encoder
// (one head of 512) and decoder (2 heads of 320) run here in bf16. The f32
// widths stay on the tiled CUDA-core kernels (csrc/attention_tiled.cu,
// csrc/attention_bwd_tiled.cu: exact f32, which the f32 step-parity checks
// need). Same function and roundings as the other K1
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
// `ld` elements apart) -> rows S bytes apart at dst; columns [cols, pad) of
// those rows and columns [0, pad) of rows [rows, max_rows) set to zero.
// `vec`: 16-byte cp.async (src 16-byte aligned, ld and cols multiples of
// 8); else element by element.
template <int S = kStride>
__device__ __forceinline__ void stage(uint8_t* dst,
                                      const __nv_bfloat16* __restrict__ src,
                                      long long ld, int rows, int max_rows,
                                      int cols, int pad, bool vec, int tid) {
  if (vec) {
    const int units = cols / 8;
    for (int e = tid; e < rows * units; e += kThreads) {
      const int r = e / units;
      const int u = e - r * units;
      cp_async16(dst + r * S + 16 * u, src + r * ld + 8 * u);
    }
  } else {
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int r = e / cols;
      const int c = e - r * cols;
      reinterpret_cast<__nv_bfloat16*>(dst + r * S)[c] = src[r * ld + c];
    }
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const int tail = pad - cols;
  for (int e = tid; e < rows * tail; e += kThreads) {
    const int r = e / tail;
    reinterpret_cast<__nv_bfloat16*>(dst + r * S)[cols + e - r * tail] = zero;
  }
  for (int e = tid; e < (max_rows - rows) * pad; e += kThreads) {
    const int r = rows + e / pad;
    reinterpret_cast<__nv_bfloat16*>(dst + r * S)[e % pad] = zero;
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

// ---- backward (K2) ----
//
// dq, dk, dv (and dbias) of the forward above, for bf16 heads wider than
// 256 (the f32 ones take csrc/attention_bwd_tiled.cu). With
// g the cotangent of out,
//     dv = pc^T g, dp = g v^T, ds = p (dp - rowsum(dp p))   (f32)
//     dq = dss k, dk = dss^T q, dss = (ds * (1/scale)) rounded to bf16
//     dbias = sum_h ds                         (f32, heads 0..H-1)
// What bounds it: the bytes and their latency, as the forward. At N = 64,
// Lq = Lk = 32, one head of 512, a call reads q, k, v, g (8.4 MB) and the
// bias (0.26 MB) and writes dq, dk, dv (6.3 MB): 0.0045 ms at 3.35 TB/s,
// against 1.3 GFLOP (1.4 us on the tensor cores). The design before this
// one (the chunked CUDA-core kernels: a warp per query or key,
// each logit a dot product summed by shuffles, three passes over the keys)
// took 0.30-0.42 ms there.
//
// Design: the forward's split of the logits' k-steps over warps and the
// wide K2's two phases (csrc/attention_wide_mma.cu). A block of eight warps
// per (batch row, head, group of kBGroup output columns): the encoder's one
// head of 512 gives 4 blocks a row (256 at N = 64; a (row, head) alone
// would give 64 blocks for 132 SMs), each forming S and dP again (32 x 32 x
// Dh multiply-adds, cheap). Warp w holds m-tile m = w % 2 (16 queries) and
// split j = w / 2: S = q k^T and dP = g v^T of its m-tile over k-steps j
// per .. of each chunk of kBChunk columns of q, g, k, v (staged, zero past
// Dh and past the rows), its partials to a slot of shared memory over the
// staged chunk, and every warp adds the kSplit partials of its m-tile in
// split order: all hold the same S and dP bit for bit. Phase A: p, rowsum
// (dp p) and ds on the accumulators, dQ = dss k over the warp's quarter of
// the group (the group's columns of k staged apart), warp j = 0 writing pc
// and dss as bf16 (query, key) tiles; phase B: dV = pc^T g and dK = dss^T
// q for keys 16 m.., their A operands read with ldmatrix.x4.trans (the
// tiles of mma_row.cuh). Past 32 queries or keys two kernels, as the wide
// K2: the dq kernel per (row, head, 32 queries, group) streams the key
// tiles twice (the running max, sum and rowsum, then ds and dQ) and writes
// (m, l, rowsum) per query to the statistics scratch (N, H, Lq, 4); the
// dk/dv kernel per (row, head, 32 keys, group) streams the query tiles with
// their statistics. dbias: the first group's blocks write each head's f32
// ds to the scratch (N, H, Lq, Lk), and a last kernel sums it over the
// heads in order. No atomics, one writer per output element: the same bits
// on every call, dq, dk and dv the same with or without dbias.

constexpr int kT = 32;              // queries or keys a tile: two m-tiles
constexpr int kBChunk = 256;        // columns of q, g, k, v staged at a time
constexpr int kBGroup = 128;        // output columns a block writes
constexpr int kSplit = kWarps / 2;  // warps of an m-tile
constexpr int kBNT = kBGroup / 8 / kSplit;  // n-tiles of output a warp
// bytes between staged rows: 33 and 17 16-byte units, odd
constexpr int kBStride = 16 * (kBChunk / 8 + 1);
constexpr int kGStride = 16 * (kBGroup / 8 + 1);
constexpr int kSlotFloats = 32;  // a thread's partial S and dP
constexpr size_t kChunkBytes = 4 * (size_t)kT * kBStride;
// the staged chunks (the slot over them), the group's q, g, k; the bias
// tile; the pc and dss tiles; the statistics
constexpr size_t kBwdSmemBytes = kChunkBytes + 3 * (size_t)kT * kGStride +
                                 sizeof(float) * kT * mrow::kBiasStride +
                                 2 * kT * mrow::kPStride + sizeof(float4) * kT;
static_assert(sizeof(float) * kWarps * kSlotFloats * 32 <= kChunkBytes,
              "the slot lies over the staged chunks");

struct BwdSmem {
  uint8_t *qs, *gs, *ks, *vs, *qg, *gg, *kg, *ps, *dss;
  float *slot, *bs;
  float4* st;
  __device__ explicit BwdSmem(uint8_t* raw) {
    constexpr int chunk = kT * kBStride;
    constexpr int group = kT * kGStride;
    qs = raw;
    gs = qs + chunk;
    ks = gs + chunk;
    vs = ks + chunk;
    slot = reinterpret_cast<float*>(raw);
    qg = vs + chunk;
    gg = qg + group;
    kg = gg + group;
    bs = reinterpret_cast<float*>(kg + group);
    ps = reinterpret_cast<uint8_t*>(bs + kT * mrow::kBiasStride);
    dss = ps + kT * mrow::kPStride;
    st = reinterpret_cast<float4*>(dss + kT * mrow::kPStride);
  }
};

// Where a thread stands: fragment row g, byte column c4 (= 2 c2) of its
// pair, m-tile m and split j of its warp, whose output columns are the
// group's n-tiles t0() ..
struct Pos {
  int tid, warp, lane, g, c2, c4, m, j;
  __device__ Pos()
      : tid(threadIdx.x), warp(tid >> 5), lane(tid & 31), g(lane >> 2),
        c2(2 * (lane & 3)), c4(4 * (lane & 3)), m(warp & 1), j(warp >> 1) {}
  __device__ int r0() const { return 16 * m + g; }
  __device__ int t0() const { return kBNT * j; }
};

// S = q k^T (into s) and dP = g v^T (into dp) of the warp's m-tile, over
// the whole head: queries at qb and gb, ql rows; keys at kb and vb, kl rows;
// rows hd elements apart. Each chunk of kBChunk columns is staged and each
// warp adds its share of the chunk's k-steps to its partials, which go to
// the slot; every warp then adds its m-tile's kSplit partials in split
// order. Starts with a barrier of the block (the caller's staged tiles
// land with the first chunk), and leaves the slot over the staged chunk.
__device__ __forceinline__ void logits_bwd(float (&s)[4][4],
                                           float (&dp)[4][4],
                                           const BwdSmem& sm,
                                           const __nv_bfloat16* qb,
                                           const __nv_bfloat16* gb,
                                           const __nv_bfloat16* kb,
                                           const __nv_bfloat16* vb,
                                           long long hd, int ql, int kl,
                                           int dh, bool vec, const Pos& p) {
  float ps[4][4], pd[4][4];
  mrow::zero(ps);
  mrow::zero(pd);
  const int oa = p.r0() * kBStride + p.c4;
  const int ob = p.g * kBStride + p.c4;
  for (int c0 = 0; c0 < dh; c0 += kBChunk) {
    const int cols = min(kBChunk, dh - c0);
    const int pad = round_up(cols, 16);
    __syncthreads();  // the last reads of the staged chunk or the slot
    stage<kBStride>(sm.qs, qb + c0, hd, ql, kT, cols, pad, vec, p.tid);
    stage<kBStride>(sm.gs, gb + c0, hd, ql, kT, cols, pad, vec, p.tid);
    stage<kBStride>(sm.ks, kb + c0, hd, kl, kT, cols, pad, vec, p.tid);
    stage<kBStride>(sm.vs, vb + c0, hd, kl, kT, cols, pad, vec, p.tid);
    cp_async_wait_all();
    __syncthreads();
    const int nks = pad / 16;
    const int per = (nks + kSplit - 1) / kSplit;
    const int hi = min(nks, (p.j + 1) * per);
    for (int kk = p.j * per; kk < hi; ++kk) {
      uint32_t fq[4], fg[4];
      mrow::frag_a(fq, sm.qs + oa + 32 * kk, kBStride);
      mrow::frag_a(fg, sm.gs + oa + 32 * kk, kBStride);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int o = ob + 8 * nj * kBStride + 32 * kk;
        mma16816(ps[nj], fq, lds32(sm.ks + o), lds32(sm.ks + o + 16));
        mma16816(pd[nj], fg, lds32(sm.vs + o), lds32(sm.vs + o + 16));
      }
    }
  }
  __syncthreads();  // every warp is past the staged chunk
  float* mine = sm.slot + p.warp * kSlotFloats * 32 + p.lane;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[(4 * nj + e) * 32] = ps[nj][e];
      mine[(16 + 4 * nj + e) * 32] = pd[nj][e];
    }
  __syncthreads();
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* at = sm.slot + p.m * kSlotFloats * 32 + p.lane +
                        (4 * nj + e) * 32;
      float x = at[0], y = at[16 * 32];
#pragma unroll
      for (int jj = 1; jj < kSplit; ++jj) {
        x += at[2 * jj * kSlotFloats * 32];
        y += at[2 * jj * kSlotFloats * 32 + 16 * 32];
      }
      s[nj][e] = x;
      dp[nj][e] = y;
    }
}

// up to 32 queries and keys: block (row and head, group)
__global__ void __launch_bounds__(kThreads, 2)
chunked_mma_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ g,
                       __nv_bfloat16* __restrict__ dq,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv,
                       float* __restrict__ ds_out, Shape sh, int vec) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const BwdSmem sm(smem_raw);
  const Pos p;
  const long long nh = blockIdx.x;
  const int h = (int)(nh % sh.heads);
  const long long n = nh / sh.heads;
  const int c0 = blockIdx.y * kBGroup;
  const int gcols = min(kBGroup, sh.dh - c0);
  const long long hd = (long long)sh.heads * sh.dh;
  const long long q_at = n * sh.lq * hd + (long long)h * sh.dh;
  const long long k_at = n * sh.lk * hd + (long long)h * sh.dh;
  stage<kGStride>(sm.qg, q + q_at + c0, hd, sh.lq, kT, gcols, kBGroup,
                  vec != 0, p.tid);
  stage<kGStride>(sm.gg, g + q_at + c0, hd, sh.lq, kT, gcols, kBGroup,
                  vec != 0, p.tid);
  stage<kGStride>(sm.kg, k + k_at + c0, hd, sh.lk, kT, gcols, kBGroup,
                  vec != 0, p.tid);
  mrow::stage_bias_window(sm.bs, bias + n * sh.lq * sh.lk, sh.lq, sh.lk,
                          sh.lk, p.tid, kThreads);
  float sc[4][4], dp[4][4];
  logits_bwd(sc, dp, sm, q + q_at, g + q_at, k + k_at, v + k_at, hd, sh.lq,
             sh.lk, sh.dh, vec != 0, p);

  // phase A: p, ds and dQ of m-tile p.m over the warp's columns
  if (16 * p.m < sh.lq) {
    float sum[2];
    mrow::softmax_exp(sc, sm.bs, p.r0(), p.c2, sh.lk, sh.inv_scale, sum);
    mrow::exact_ds(sc, dp, sum, sh.lq, p.r0());
    uint32_t dsk[4][2], a[2][4];
    mrow::pack(dsk, dp, sh.inv_scale);
    if (p.j == 0) {
      uint32_t pk[4][2];
      mrow::pack(pk, sc, 1.f);
      mrow::put_tile(sm.ps, pk, p.r0(), p.c2);
      mrow::put_tile(sm.dss, dsk, p.r0(), p.c2);
      if (ds_out != nullptr && blockIdx.y == 0)
        mrow::store_ds(ds_out + nh * sh.lq * sh.lk, sh.lk, dp, sh.lq, sh.lk,
                       p.r0(), p.c2);
    }
    float dqa[kBNT][4];
    mrow::zero_out(dqa);
    mrow::to_a(a, dsk);
    mrow::out_products(dqa, a, sm.kg, kGStride, sh.lk > 16 ? 2 : 1, p.lane,
                       p.t0());
    mrow::store_out(dq + q_at + c0, hd, dqa, sh.lq, gcols, p.r0(), p.c2,
                    p.t0(), (sh.dh & 1) == 0);
  }
  __syncthreads();  // the pc and dss tiles are whole
  // phase B: dV and dK of keys 16 p.m.. over the warp's columns
  if (16 * p.m < sh.lk) {
    float dva[kBNT][4], dka[kBNT][4];
    mrow::zero_out(dva);
    mrow::zero_out(dka);
    mrow::dkv_products(dva, dka, sm.ps, sm.dss, sm.gg, sm.qg, kGStride,
                       sh.lq > 16 ? 2 : 1, p.m, p.t0(), p.lane);
    mrow::store_out(dv + k_at + c0, hd, dva, sh.lk, gcols, p.r0(), p.c2,
                    p.t0(), (sh.dh & 1) == 0);
    mrow::store_out(dk + k_at + c0, hd, dka, sh.lk, gcols, p.r0(), p.c2,
                    p.t0(), (sh.dh & 1) == 0);
  }
}

// past 32 queries or keys, dq and the statistics: block (row and head,
// tile of 32 queries, group)
__global__ void __launch_bounds__(kThreads, 2)
chunked_mma_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ bias,
                          const __nv_bfloat16* __restrict__ g,
                          __nv_bfloat16* __restrict__ dq,
                          float4* __restrict__ stats,
                          float* __restrict__ ds_out, Shape sh, int vec) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const BwdSmem sm(smem_raw);
  const Pos p;
  const long long nh = blockIdx.x;
  const int h = (int)(nh % sh.heads);
  const long long n = nh / sh.heads;
  const int q0 = blockIdx.y * kT;
  const int ql = min(kT, sh.lq - q0);
  const int c0 = blockIdx.z * kBGroup;
  const int gcols = min(kBGroup, sh.dh - c0);
  const long long hd = (long long)sh.heads * sh.dh;
  const long long q_at = (n * sh.lq + q0) * hd + (long long)h * sh.dh;
  const long long k_at = n * sh.lk * hd + (long long)h * sh.dh;

  const bool active = 16 * p.m < ql;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float rowsum[2] = {0.f, 0.f};
  float dqa[kBNT][4];
  mrow::zero_out(dqa);
  const int nkt = (sh.lk + kT - 1) / kT;
  // pass 0: the running max, sum and sum of e dp; pass 1: ds and dQ
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * kT;
      const int kl = min(kT, sh.lk - k0);
      const long long kt_at = k_at + k0 * hd;
      __syncthreads();  // the last tile's reads of the bias and kg are done
      mrow::stage_bias_window(sm.bs, bias + (n * sh.lq + q0) * sh.lk + k0,
                              ql, kl, sh.lk, p.tid, kThreads);
      if (pass == 1)
        stage<kGStride>(sm.kg, k + kt_at + c0, hd, kl, kT, gcols, kBGroup,
                        vec != 0, p.tid);
      float sc[4][4], dp[4][4];
      logits_bwd(sc, dp, sm, q + q_at, g + q_at, k + kt_at, v + kt_at, hd,
                 ql, kl, sh.dh, vec != 0, p);
      if (!active) continue;
      float tmax[2];
      mrow::tile_logits(sc, sm.bs, p.r0(), p.c2, kl, sh.inv_scale, tmax);
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
        mrow::quad_sum(tl);
        mrow::quad_sum(tr);
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
          const float pr = mrow::div_rn(expf(sc[nj][e] - m[r]), l[r], rs[r]);
          dp[nj][e] = p.r0() + 8 * r < ql
                          ? __fmul_rn(pr, __fsub_rn(dp[nj][e], rowsum[r]))
                          : 0.f;
        }
      if (ds_out != nullptr && blockIdx.z == 0 && p.j == 0)
        mrow::store_ds(ds_out + (nh * sh.lq + q0) * sh.lk + k0, sh.lk, dp,
                       ql, kl, p.r0(), p.c2);
      uint32_t dsk[4][2], a[2][4];
      mrow::pack(dsk, dp, sh.inv_scale);
      mrow::to_a(a, dsk);
      mrow::out_products(dqa, a, sm.kg, kGStride, kl > 16 ? 2 : 1, p.lane,
                         p.t0());
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) rowsum[r] = __fdiv_rn(rowsum[r], l[r]);
    }
  }
  if (!active) return;
  if (blockIdx.z == 0 && p.j == 0 && (p.lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = p.r0() + 8 * r;
      if (i < ql)
        stats[nh * sh.lq + q0 + i] = make_float4(m[r], l[r], rowsum[r], 0.f);
    }
  }
  mrow::store_out(dq + q_at + c0, hd, dqa, ql, gcols, p.r0(), p.c2, p.t0(),
                  (sh.dh & 1) == 0);
}

// past 32 queries or keys, dk and dv: block (row and head, tile of 32
// keys, group), the query tiles streamed with their statistics
__global__ void __launch_bounds__(kThreads, 2)
chunked_mma_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ bias,
                           const __nv_bfloat16* __restrict__ g,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv,
                           const float4* __restrict__ stats, Shape sh,
                           int vec) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const BwdSmem sm(smem_raw);
  const Pos p;
  const long long nh = blockIdx.x;
  const int h = (int)(nh % sh.heads);
  const long long n = nh / sh.heads;
  const int k0 = blockIdx.y * kT;
  const int kl = min(kT, sh.lk - k0);
  const int c0 = blockIdx.z * kBGroup;
  const int gcols = min(kBGroup, sh.dh - c0);
  const long long hd = (long long)sh.heads * sh.dh;
  const long long k_at = (n * sh.lk + k0) * hd + (long long)h * sh.dh;
  const long long q_at = n * sh.lq * hd + (long long)h * sh.dh;

  float dva[kBNT][4], dka[kBNT][4];
  mrow::zero_out(dva);
  mrow::zero_out(dka);
  for (int q0 = 0; q0 < sh.lq; q0 += kT) {
    const int ql = min(kT, sh.lq - q0);
    const long long qt_at = q_at + q0 * hd;
    __syncthreads();  // the last tile's reads of the staged tiles are done
    stage<kGStride>(sm.qg, q + qt_at + c0, hd, ql, kT, gcols, kBGroup,
                    vec != 0, p.tid);
    stage<kGStride>(sm.gg, g + qt_at + c0, hd, ql, kT, gcols, kBGroup,
                    vec != 0, p.tid);
    mrow::stage_bias_window(sm.bs, bias + (n * sh.lq + q0) * sh.lk + k0,
                            ql, kl, sh.lk, p.tid, kThreads);
    for (int e = p.tid; e < kT; e += kThreads) {
      if (e < ql)
        cp_async16(sm.st + e, stats + nh * sh.lq + q0 + e);
      else
        sm.st[e] = make_float4(0.f, 1.f, 0.f, 0.f);
    }
    float sc[4][4], dp[4][4];
    logits_bwd(sc, dp, sm, q + qt_at, g + qt_at, k + k_at, v + k_at, hd, ql,
               kl, sh.dh, vec != 0, p);
    // phase A, split 0: pc and dss of query m-tile p.m from the statistics
    if (16 * p.m < ql && p.j == 0) {
      float tmax[2];
      mrow::tile_logits(sc, sm.bs, p.r0(), p.c2, kl, sh.inv_scale, tmax);
      float4 sr[2];
      sr[0] = sm.st[p.r0()];
      sr[1] = sm.st[p.r0() + 8];
      const float rs[2] = {__frcp_rn(sr[0].y), __frcp_rn(sr[1].y)};
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool in = p.r0() + 8 * r < ql;
          const float pr =
              in ? mrow::div_rn(expf(sc[nj][e] - sr[r].x), sr[r].y, rs[r])
                 : 0.f;
          sc[nj][e] = pr;
          dp[nj][e] = in ? __fmul_rn(pr, __fsub_rn(dp[nj][e], sr[r].z)) : 0.f;
        }
      uint32_t pk[4][2];
      mrow::pack(pk, sc, 1.f);
      mrow::put_tile(sm.ps, pk, p.r0(), p.c2);
      mrow::pack(pk, dp, sh.inv_scale);
      mrow::put_tile(sm.dss, pk, p.r0(), p.c2);
    }
    __syncthreads();  // the pc and dss tiles are whole
    // phase B: dV and dK of keys 16 p.m.. over this query tile
    if (16 * p.m < kl)
      mrow::dkv_products(dva, dka, sm.ps, sm.dss, sm.gg, sm.qg, kGStride,
                         ql > 16 ? 2 : 1, p.m, p.t0(), p.lane);
  }
  if (16 * p.m < kl) {
    mrow::store_out(dv + k_at + c0, hd, dva, kl, gcols, p.r0(), p.c2,
                    p.t0(), (sh.dh & 1) == 0);
    mrow::store_out(dk + k_at + c0, hd, dka, kl, gcols, p.r0(), p.c2,
                    p.t0(), (sh.dh & 1) == 0);
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

// As the forward, with g and dq shaped like q, dk and dv like k; dbias f32
// (N, Lq, Lk) or null; `stats` the caller's f32 scratch (N, heads, Lq, 4),
// 16-byte aligned, which past 32 queries or keys carries the softmax
// statistics from the dq kernel to the dk/dv kernel (else it may be null);
// `ds` the caller's f32 scratch (N, heads, Lq, Lk) for dbias (null without
// dbias).
int deepsc_attention_chunked_bwd_bf16(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* g, void* dq, void* dk,
                                      void* dv, void* dbias, void* stats,
                                      void* ds, int n, int lq, int lk,
                                      int heads, int dh, double scale,
                                      void* stream) {
  if (n <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || dh <= 0 ||
      (dbias != nullptr) != (ds != nullptr))
    return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  const bool one = lq <= kT && lk <= kT;
  if (!one && stats == nullptr) return (int)cudaErrorInvalidValue;
  const void* kernels[3] = {(const void*)chunked_mma_bwd_kernel,
                            (const void*)chunked_mma_bwd_dq_kernel,
                            (const void*)chunked_mma_bwd_dkv_kernel};
  for (const void* kernel : kernels) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kBwdSmemBytes);
    if (err) return err;
  }
  // 1/scale in double, rounded once to f32, as the other kernels
  const Shape sh{n, lq, lk, heads, dh, (float)(1.0 / scale)};
  const int vec = dh % 8 == 0;
  const unsigned nh = (unsigned)((long long)n * heads);
  const unsigned groups = (unsigned)((dh + kBGroup - 1) / kBGroup);
  float* dsp = dbias != nullptr ? (float*)ds : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (one) {
    chunked_mma_bwd_kernel<<<dim3(nh, groups), kThreads, kBwdSmemBytes,
                             st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (T*)dq, (T*)dk, (T*)dv, dsp, sh, vec);
  } else {
    chunked_mma_bwd_dq_kernel<<<dim3(nh, (lq + kT - 1) / kT, groups),
                                kThreads, kBwdSmemBytes, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (T*)dq, (float4*)stats, dsp, sh, vec);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    chunked_mma_bwd_dkv_kernel<<<dim3(nh, (lk + kT - 1) / kT, groups),
                                 kThreads, kBwdSmemBytes, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
        (const T*)g, (T*)dk, (T*)dv, (const float4*)stats, sh, vec);
  }
  int err = (int)cudaGetLastError();
  if (err || dbias == nullptr) return err;
  return mrow::sum_dbias((const float*)ds, (float*)dbias, n, heads, lq, lk,
                         st);
}

}  // extern "C"
