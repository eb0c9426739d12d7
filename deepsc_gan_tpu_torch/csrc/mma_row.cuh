// Pieces of the bf16 attention kernels (the forward csrc/attention_fwd.cu
// and the backward csrc/attention_bwd.cu) for Hopper (sm_90a): one batch
// row staged into shared memory with cp.async, mma.sync m16n8k16 products
// on its tiles, and the softmax of a row of logits on the accumulators.
//
// Staging. A batch row of q, k, v (and g) is (L, H*Dh) bf16. A block
// copies the columns it needs of up to 32 rows (all of a row when L <= 32,
// one 32-row tile of it in the long-length kernels; 16-byte cp.async
// chunks) into a tile of kRows rows whose stride is the copied width plus
// 16 or 32 bytes, so that a row takes an odd number of 16-byte units: the
// eight rows that a fragment load or an ldmatrix reads then fall in distinct
// banks. The f32 bias tile (Lq, Lk) goes in with 4-byte cp.async (a row of
// 31 x 31 floats seldom starts on 16 bytes) at kBiasStride floats a row.
//
// Fragments of m16n8k16 (thread t of a warp, g = t / 4, c = t % 4): A
// (16 x 16) holds rows g and g + 8, columns 2c, 2c + 1 and 8 + 2c, 9 + 2c;
// B (16 x 8) rows 2c, 2c + 1 and 8 + 2c, 9 + 2c of column g; C (16 x 8)
// rows g and g + 8, columns 2c, 2c + 1. So the accumulators of a 16-row
// tile of logits S (four n-tiles of 8 keys) hold a row's 32 logits in one
// quad, and n-tiles 2 kk and 2 kk + 1, rounded to bf16 and packed in
// pairs, are the A operand of k-step kk of a product with K = keys (the
// accumulator-to-A identity).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mrow {

constexpr int kRows = 32;        // staged rows of a tile (queries or keys)
constexpr int kBiasStride = 40;  // floats per staged bias row

// bytes between staged rows of `chunks` 16-byte chunks: an odd number of
// 16-byte units
__host__ __device__ __forceinline__ int row_stride(int chunks) {
  return 16 * (chunks + (chunks % 2 == 0 ? 1 : 2));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Rows of N tensors of one layout at once (one index computation for all;
// a row offset fits an int: at most 32 rows of 1,024 bytes and padding).

// `rows` rows of `chunks` 16-byte chunks of each src[t], `src_stride` bytes
// apart in device memory -> staged rows of dst[t] `stride` bytes apart, by
// the block's `nt` threads
template <int N>
__device__ __forceinline__ void stage_rows(uint8_t* const (&dst)[N],
                                           int stride,
                                           const uint8_t* const (&src)[N],
                                           int src_stride, int rows,
                                           int chunks, int tid, int nt) {
  for (int c = tid; c < rows * chunks; c += nt) {
    const int r = c / chunks;
    const int o = 16 * (c - r * chunks);
#pragma unroll
    for (int t = 0; t < N; ++t)
      cp_async16(dst[t] + r * stride + o, src[t] + r * src_stride + o);
  }
}

// staged rows [from, kRows) of each dst[t] set to zero (a product over them
// then adds 0, never a stale NaN)
template <int N>
__device__ __forceinline__ void zero_rows(uint8_t* const (&dst)[N],
                                          int stride, int from, int chunks,
                                          int tid, int nt) {
  for (int c = tid; c < (kRows - from) * chunks; c += nt) {
    const int r = from + c / chunks;
#pragma unroll
    for (int t = 0; t < N; ++t)
      *reinterpret_cast<uint4*>(dst[t] + r * stride + 16 * (c % chunks)) =
          make_uint4(0, 0, 0, 0);
  }
}

// the contiguous (lq, lk) f32 bias tile -> rows kBiasStride floats apart
__device__ __forceinline__ void stage_bias(float* bs, const float* bg,
                                           int lq, int lk, int tid, int nt) {
  for (int e = tid; e < lq * lk; e += nt) {
    const int i = e / lk;
    cp_async4(bs + i * kBiasStride + (e - i * lk), bg + e);
  }
}

// a (rows, cols) window of an f32 bias whose rows are `ld` floats apart ->
// rows kBiasStride floats apart (the long-length kernels' 32 x 32 tiles)
__device__ __forceinline__ void stage_bias_tile(float* bs, const float* bg,
                                                int rows, int cols, int ld,
                                                int tid, int nt) {
  for (int e = tid; e < rows * cols; e += nt) {
    const int i = e / cols;
    const int j = e - i * cols;
    cp_async4(bs + i * kBiasStride + j, bg + (long long)i * ld + j);
  }
}

// staged rows of each src[t], `stride` bytes apart -> `rows` rows of dst[t]
// `dst_stride` bytes apart in device memory (16-byte stores)
template <int N>
__device__ __forceinline__ void store_rows(uint8_t* const (&dst)[N],
                                           int dst_stride,
                                           const uint8_t* const (&src)[N],
                                           int stride, int rows, int chunks,
                                           int tid, int nt) {
  for (int c = tid; c < rows * chunks; c += nt) {
    const int r = c / chunks;
    const int o = 16 * (c - r * chunks);
#pragma unroll
    for (int t = 0; t < N; ++t)
      *reinterpret_cast<uint4*>(dst[t] + r * dst_stride + o) =
          *reinterpret_cast<const uint4*>(src[t] + r * stride + o);
  }
}

// a / b rounded, for 0 <= a < 2^64 and b >= 1, from r = 1/b rounded: the
// product's error corrected by one fma (Markstein), on a scaled by 2^64 so
// that the remainder cannot underflow (scalings by powers of two are
// exact). It equals __fdiv_rn(a, b) wherever the quotient is normal; a
// subnormal one (below 1.2e-38) may differ in its last bit, rounded twice
// (scripts/kernel_variants.py holds it against __fdiv_rn on the card). It
// takes 5 instructions where __fdiv_rn takes about 10 and a branch.
__device__ __forceinline__ float div_rn(float a, float b, float r) {
  const float up = __int_as_float(0x5f800000);    // 2^64
  const float down = __int_as_float(0x1f800000);  // 2^-64
  const float sa = __fmul_rn(a, up);
  const float q = __fmul_rn(sa, r);
  return __fmul_rn(__fmaf_rn(__fmaf_rn(-q, b, sa), r, q), down);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// the transposed fragments of two 8 x 8 bf16 matrices whose rows lanes
// 0-7 and 8-15 address: the B operand (16 keys x 8 columns) of an m16n8k16
// product from a row-major (key, column) tile
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const uint8_t* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_u32(row))
      : "memory");
}

// the transpose of an 8 x 8 bf16 matrix held as one register per thread
// (thread t: row t / 4, columns 2 (t % 4) and 2 (t % 4) + 1), in the same
// layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// c += a . b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The softmax numerators of one 16-row tile of logits on its accumulators
// sc (rows r0 and r0 + 8 of this thread, r0 = 16 m + g; keys 8 nj + c2 +
// (e & 1), c2 = 2 (t % 4)): the logit (q . k) * (1/scale), then + bias,
// each step rounded as the TPU kernel does; keys past lk at -inf, out of
// the max and the sum. On return sc holds exp(logit - row max) and sum[r]
// the row sums of rows r0 + 8 r (two shuffles each in the quad).
__device__ __forceinline__ void softmax_exp(float (&sc)[4][4], const float* bs,
                                            int r0, int c2, int lk,
                                            float inv_scale, float (&sum)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + 8 * (e >> 1);
      const int j = 8 * nj + c2 + (e & 1);
      const float x = j < lk ? __fadd_rn(__fmul_rn(sc[nj][e], inv_scale),
                                         bs[i * kBiasStride + j])
                             : -INFINITY;
      sc[nj][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    sum[r] = 0.f;
  }
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[nj][e] = expf(sc[nj][e] - mx[e >> 1]);
      sum[e >> 1] += sc[nj][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
}

// The logits of one 16-row tile of a 32-key tile on its accumulators (as
// softmax_exp: (q . k) * (1/scale), then + bias, keys past kl at -inf), in
// place; tmax[r] gets the tile's max of rows r0 + 8 r over the quad. The
// long-length kernels' online softmax starts from these.
__device__ __forceinline__ void tile_logits(float (&sc)[4][4], const float* bs,
                                            int r0, int c2, int kl,
                                            float inv_scale,
                                            float (&tmax)[2]) {
  tmax[0] = tmax[1] = -INFINITY;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + 8 * (e >> 1);
      const int j = 8 * nj + c2 + (e & 1);
      const float x = j < kl ? __fadd_rn(__fmul_rn(sc[nj][e], inv_scale),
                                         bs[i * kBiasStride + j])
                             : -INFINITY;
      sc[nj][e] = x;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
  }
}

// the sum over the quad of a value of rows r0 and r0 + 8
__device__ __forceinline__ void quad_sum(float (&x)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x[r] += __shfl_xor_sync(0xffffffffu, x[r], 1);
    x[r] += __shfl_xor_sync(0xffffffffu, x[r], 2);
  }
}

// ---- the backward's tiles, shared by csrc/attention_wide_mma.cu and
// csrc/attention_chunked.cu ----
//
// A block's warps each hold one 16-row m-tile (queries; keys in dK and dV)
// and n-tiles t0.. of an output's columns. pc and dss go between warps as
// bf16 (query, key) tiles of 32 x 32 in shared memory, kPStride bytes a row
// (32 bf16 and 16 bytes, five 16-byte units).

constexpr int kPStride = 80;

// the (rows, cols) window of an f32 bias at bg, rows `ld` floats apart ->
// the kRows x kRows tile at bs, kBiasStride floats a row, zero outside the
// window, by the block's `nt` threads
__device__ __forceinline__ void stage_bias_window(float* bs,
                                                  const float* __restrict__ bg,
                                                  int rows, int cols, int ld,
                                                  int tid, int nt) {
  for (int e = tid; e < kRows * kRows; e += nt) {
    const int i = e >> 5;
    const int j = e & 31;
    float* d = bs + i * kBiasStride + j;
    if (i < rows && j < cols)
      cp_async4(d, bg + (long long)i * ld + j);
    else
      *d = 0.f;
  }
}

__device__ __forceinline__ void zero(float (&x)[4][4]) {
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nj][e] = 0.f;
}

template <int NT>
__device__ __forceinline__ void zero_out(float (&x)[NT][4]) {
#pragma unroll
  for (int dn = 0; dn < NT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[dn][e] = 0.f;
}

// the A fragment whose row g, column 2 (t % 4) is at byte p
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const uint8_t* p,
                                       int stride) {
  f[0] = lds32(p);
  f[1] = lds32(p + 8 * stride);
  f[2] = lds32(p + 16);
  f[3] = lds32(p + 8 * stride + 16);
}

// accumulators of a 16 x 32 tile rounded to bf16 in pairs (pk[nj][half]:
// row g + 8 half, columns 8 nj + c2, + 1), each value times `mul`
__device__ __forceinline__ void pack(uint32_t (&pk)[4][2],
                                     const float (&x)[4][4], float mul) {
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      pk[nj][half] = pack_bf16(__fmul_rn(x[nj][2 * half], mul),
                               __fmul_rn(x[nj][2 * half + 1], mul));
}

// the packed pairs as the A operand of the two 16-key k-steps of a product
// with K = keys (the accumulator-to-A identity)
__device__ __forceinline__ void to_a(uint32_t (&a)[2][4],
                                     const uint32_t (&pk)[4][2]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a[kk][0] = pk[2 * kk][0];
    a[kk][1] = pk[2 * kk][1];
    a[kk][2] = pk[2 * kk + 1][0];
    a[kk][3] = pk[2 * kk + 1][1];
  }
}

// acc[dn] += a[kk] . rows 16 kk.. of the staged b (rows `stride` bytes
// apart; n-tile t0 + dn) over the k-steps kk < nk that hold data (b through
// ldmatrix.trans)
template <int NT>
__device__ __forceinline__ void out_products(float (&acc)[NT][4],
                                             const uint32_t (&a)[2][4],
                                             const uint8_t* b, int stride,
                                             int nk, int lane, int t0) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (kk >= nk) continue;
    const uint8_t* row = b + (16 * kk + (lane & 15)) * stride + 16 * t0;
#pragma unroll
    for (int dn = 0; dn < NT; ++dn) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, row + 16 * dn);
      mma16816(acc[dn], a[kk], b0, b1);
    }
  }
}

// a tile's packed pairs -> its rows r0, r0 + 8 of a (query, key) bf16 tile
__device__ __forceinline__ void put_tile(uint8_t* tile,
                                         const uint32_t (&pk)[4][2], int r0,
                                         int c2) {
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(tile + (r0 + 8 * half) * kPStride +
                                   2 * (8 * nj + c2)) = pk[nj][half];
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4],
                                              const uint8_t* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(row))
      : "memory");
}

// dV += pc^T g and dK += dss^T q for keys 16 m.. over the query k-steps
// kk < nq (at most KQ): A read transposed from the (query, key) tiles ps
// and dss (rows `pstride` bytes apart), g and q (staged rows `stride`
// bytes apart, n-tiles t0..) the B operands through ldmatrix.trans
template <int NT, int KQ = 2>
__device__ __forceinline__ void dkv_products(float (&dva)[NT][4],
                                             float (&dka)[NT][4],
                                             const uint8_t* ps,
                                             const uint8_t* dss,
                                             const uint8_t* gs,
                                             const uint8_t* qs, int stride,
                                             int nq, int m, int t0,
                                             int lane,
                                             int pstride = kPStride) {
  const int o = ((lane & 7) + 8 * (lane >> 4)) * pstride +
                2 * (16 * m + 8 * ((lane >> 3) & 1));
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    if (kk >= nq) continue;
    uint32_t ap[4], ad[4];
    ldsm_x4_trans(ap, ps + 16 * kk * pstride + o);
    ldsm_x4_trans(ad, dss + 16 * kk * pstride + o);
    const int row = (16 * kk + (lane & 15)) * stride + 16 * t0;
#pragma unroll
    for (int dn = 0; dn < NT; ++dn) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, gs + row + 16 * dn);
      mma16816(dva[dn], ap, b0, b1);
      ldsm_x2_trans(b0, b1, qs + row + 16 * dn);
      mma16816(dka[dn], ad, b0, b1);
    }
  }
}

// rows r0, r0 + 8 (those below `rows`) of an output m-tile's accumulators,
// columns 8 (t0 + dn) + c2, + 1 (those below cols), rounded to bf16 into
// the slice at base (rows ld elements apart); `pairs`: each pair stored as
// one 4-byte word (base and ld even: the head's width is)
template <int NT>
__device__ __forceinline__ void store_out(__nv_bfloat16* __restrict__ base,
                                          long long ld,
                                          const float (&acc)[NT][4], int rows,
                                          int cols, int r0, int c2, int t0,
                                          bool pairs) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = r0 + 8 * half;
    if (i >= rows) continue;
    __nv_bfloat16* row = base + i * ld;
#pragma unroll
    for (int dn = 0; dn < NT; ++dn) {
      const int col = 8 * (t0 + dn) + c2;
      if (col >= cols) continue;
      const float x0 = acc[dn][2 * half];
      const float x1 = acc[dn][2 * half + 1];
      if (pairs) {
        *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(x0, x1);
      } else {
        row[col] = __float2bfloat16_rn(x0);
        if (col + 1 < cols) row[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// the f32 ds of rows r0, r0 + 8 below `rows` and keys below `cols` -> the
// dbias scratch at base (rows ld floats apart)
__device__ __forceinline__ void store_ds(float* __restrict__ base, long long ld,
                                         const float (&ds)[4][4], int rows,
                                         int cols, int r0, int c2) {
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + 8 * (e >> 1);
      const int j = 8 * nj + c2 + (e & 1);
      if (i < rows && j < cols) base[i * ld + j] = ds[nj][e];
    }
}

// p (f32, 0 in rows from `rows` on) from the exact softmax numerators e and
// row sums of rows r0 and r0 + 8, rowsum(dp p) and ds = p (dp - rowsum)
// into dp
__device__ __forceinline__ void exact_ds(float (&e)[4][4], float (&dp)[4][4],
                                         const float (&sum)[2], int rows,
                                         int r0) {
  const float rs[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
  float rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = x >> 1;
      const float p = div_rn(e[nj][x], sum[r], rs[r]);
      e[nj][x] = r0 + 8 * r < rows ? p : 0.f;
      rowsum[r] = __fadd_rn(rowsum[r], __fmul_rn(dp[nj][x], e[nj][x]));
    }
  quad_sum(rowsum);
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      dp[nj][x] =
          __fmul_rn(e[nj][x], __fsub_rn(dp[nj][x], rowsum[x >> 1]));
}

// dbias of the tensor-core K2s (csrc/attention_wide_mma.cu,
// csrc/attention_chunked.cu) = the sum over heads 0..H-1, in order, of their
// f32 ds scratch (N, H, Lq, Lk): a thread per (row, query, key)
__global__ void mma_dbias_kernel(const float* __restrict__ ds,
                                 float* __restrict__ dbias, int n, int heads,
                                 int lq, int lk) {
  const long long per = (long long)lq * lk;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * per) return;
  const long long b = e / per;
  const long long o = e - b * per;
  float s = 0.f;
  for (int h = 0; h < heads; ++h)
    s = __fadd_rn(s, ds[(b * heads + h) * per + o]);
  dbias[e] = s;
}

// launches mma_dbias_kernel; cudaGetLastError() after it (0 = success)
inline int sum_dbias(const float* ds, float* dbias, int n, int heads, int lq,
                     int lk, cudaStream_t st) {
  const long long total = (long long)n * lq * lk;
  mma_dbias_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      ds, dbias, n, heads, lq, lk);
  return (int)cudaGetLastError();
}

}  // namespace mrow
