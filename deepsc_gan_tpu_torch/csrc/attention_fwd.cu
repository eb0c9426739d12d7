// Fused multi-head attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` of deepsc_gan_tpu/ops/pallas/
// attention.py (reached through `fused_attention`). Per batch row n and
// head h it computes
//     out[n, :, h*Dh:(h+1)*Dh] = softmax(q_h k_h^T * (1/scale) + bias[n]) v_h
// with q (N, Lq, H*Dh), k and v (N, Lk, H*Dh), bias (N, Lq, Lk) f32 (the
// additive -1e9 mask, shared by the heads) and out shaped like q. As in the
// TPU kernel: logits and softmax in f32; the probabilities rounded to the
// input type before the p.v product; the context summed in f32 and rounded
// to the output type. The bias is added as given: no -inf, no skipped keys,
// so a row whose keys are all blocked gives the same near-uniform weights
// as the TPU kernel.
//
// What bounds it: memory. At the decoder's self-attention on the serving
// path (N = 19 SNRs x 64 = 1,216, Lq = Lk = 31, H = 8, Dh = 16, bf16) one
// call reads q, k, v (29 MB) and the f32 bias (4.7 MB) and writes out
// (9.7 MB): about 43 MB, 13 us at the H100 SXM's 3.35 TB/s, against about
// 0.3 GFLOP (0.3 us at the bf16 tensor-core rate). Computed from the shapes.
//
// Design: bf16 only (f32 at these heads runs csrc/attention_narrow.cu):
// one warp per head, Dh in {8, 16, 32} and H <= 16 (compile-time Dh). Up to
// 32 queries and keys, one block per batch row, below; past 32 of either,
// the long-length kernel further down (a block per tile of 32 queries, the
// keys streamed in tiles of 32 with an online softmax). On the tensor cores
// (mma.sync m16n8k16, f32 accumulators): the block
//   copies the row's q, k and v (contiguous, 16-byte cp.async) and its bias
//   tile (4-byte cp.async: a row of 31 x 31 floats seldom starts on 16
//   bytes) into shared memory and waits once; the byte stream is kept in
//   flight by the several blocks each SM holds, one loading while another
//   computes. Staged rows of q, k, v are padded to an odd number of 16-byte
//   units, so the eight rows a fragment load or ldmatrix reads fall in
//   distinct banks (the staging, the softmax and the division are shared
//   with the backward through csrc/mma_row.cuh). A warp
//   computes S = q_h k_h^T as two 16-row m-tiles (one when Lq <= 16) x four
//   8-key n-tiles x Dh/16 k-steps (Dh = 8: one k-step whose upper half is
//   zero), K's fragments loaded once for both m-tiles. The softmax runs on
//   the accumulators: a row's 32 logits lie in one quad, so its max and sum
//   take two shuffles each; keys past Lk are set to -inf there (the bias has
//   no such column), and v's rows past Lk are zeroed (p = 0 times stale
//   shared memory could be NaN). The division e / sum is rounded through
//   the rounded reciprocal and one fma correction (`div_rn`): the IEEE
//   division's quotient wherever it is normal, at half its instructions.
//   With the IEEE division the kernel took 0.041 ms at the serving shape,
//   with this one 0.024 (H100, scripts/kernel_variants.py). p, rounded to
//   bf16 and packed in pairs, is the A operand of p.v as it stands (the
//   accumulator-to-A identity), and v is the B operand through
//   ldmatrix.trans. The context, rounded to bf16, goes over the warp's own
//   slice of the staged q, and the block writes rows < Lq with 16-byte
//   stores. What bounds it now: the loads and stores alone (no products,
//   no softmax) take 0.015 ms of the 0.024 (scripts/kernel_variants.py).
// The kernels allocate nothing; the caller passes the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_row.cuh"

namespace {

constexpr int kMaxHeads = 16;  // one warp per head: <= 512 threads

// ---- bf16: tensor cores (csrc/mma_row.cuh) ----

using namespace mrow;

// Fragments (thread t of a warp, g = t / 4, c = t % 4): A (16 x 16) holds
// rows g and g + 8, columns 2c, 2c + 1 and 8 + 2c, 9 + 2c; B (16 x 8) rows
// 2c, 2c + 1 and 8 + 2c, 9 + 2c of column g; C (16 x 8) rows g and g + 8,
// columns 2c, 2c + 1.
template <int DH>
__global__ void __launch_bounds__(kMaxHeads * 32)
attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, int lq, int lk,
                         int heads, float inv_scale) {
  constexpr int KS = (DH + 15) / 16;  // k-steps of q . k
  constexpr int NT = DH / 8;          // 8-column n-tiles of the context
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int row_bytes = heads * DH * 2;
  const int chunks = row_bytes / 16;
  const int stride = row_stride(chunks);
  uint8_t* qs = smem_raw;
  uint8_t* ks = qs + kRows * stride;
  uint8_t* vs = ks + kRows * stride;
  float* bs = reinterpret_cast<float*>(vs + kRows * stride);

  const long long n = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const uint8_t* qg = reinterpret_cast<const uint8_t*>(q) + n * lq * row_bytes;
  const uint8_t* kg = reinterpret_cast<const uint8_t*>(k) + n * lk * row_bytes;
  const uint8_t* vg = reinterpret_cast<const uint8_t*>(v) + n * lk * row_bytes;
  stage_rows<1>({qs}, stride, {qg}, row_bytes, lq, chunks, tid, nt);
  stage_rows<2>({ks, vs}, stride, {kg, vg}, row_bytes, lk, chunks, tid, nt);
  stage_bias(bs, bias + n * lq * lk, lq, lk, tid, nt);
  zero_rows<1>({vs}, stride, lk, chunks, tid, nt);
  cp_async_wait_all();
  __syncthreads();

  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c4 = 4 * (lane & 3);           // byte offset of column 2 (t % 4)
  const int col = (tid >> 5) * DH * 2;     // this warp's head in a row

  uint32_t kb[4][KS][2];  // B fragments of k: keys 8 nj + g
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const uint8_t* kr = ks + (8 * nj + g) * stride + col + c4;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      kb[nj][s][0] = lds32(kr + 32 * s);
      kb[nj][s][1] = DH >= 16 ? lds32(kr + 32 * s + 16) : 0u;
    }
  }
  uint32_t vb[2][NT][2];  // B fragments of v: keys 16 kk .. 16 kk + 15
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int dn = 0; dn < NT; ++dn)
      ldsm_x2_trans(vb[kk][dn][0], vb[kk][dn][1],
                    vs + (16 * kk + (lane & 15)) * stride + col + 16 * dn);

  const int mtiles = lq > 16 ? 2 : 1;
  for (int mi = 0; mi < mtiles; ++mi) {
    const int r0 = 16 * mi + g;  // this thread's rows r0 and r0 + 8
    const uint8_t* q0 = qs + r0 * stride + col + c4;
    const uint8_t* q1 = q0 + 8 * stride;
    uint32_t qa[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      qa[s][0] = lds32(q0 + 32 * s);
      qa[s][1] = lds32(q1 + 32 * s);
      qa[s][2] = DH >= 16 ? lds32(q0 + 32 * s + 16) : 0u;
      qa[s][3] = DH >= 16 ? lds32(q1 + 32 * s + 16) : 0u;
    }
    float sc[4][4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nj][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s)
        mma16816(sc[nj], qa[s], kb[nj][s][0], kb[nj][s][1]);
    }

    // the logits' exponentials and row sums, keys past lk at 0
    float sum[2];
    softmax_exp(sc, bs, r0, c4 >> 1, lk, inv_scale, sum);
    // p = e / sum, rounded to bf16: n-tiles 2 kk and 2 kk + 1 are the A
    // operand of k-step kk of p . v
    const float rs[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* x = sc[2 * kk + half];
        pa[kk][2 * half] = pack_bf16(div_rn(x[0], sum[0], rs[0]),
                                     div_rn(x[1], sum[0], rs[0]));
        pa[kk][2 * half + 1] = pack_bf16(div_rn(x[2], sum[1], rs[1]),
                                         div_rn(x[3], sum[1], rs[1]));
      }
    float o[NT][4];
#pragma unroll
    for (int dn = 0; dn < NT; ++dn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma16816(o[dn], pa[kk], vb[kk][dn][0], vb[kk][dn][1]);
    }
    // the context over this warp's slice of rows r0 and r0 + 8 of q, which
    // only this warp reads, and which it has read
    __syncwarp();
#pragma unroll
    for (int dn = 0; dn < NT; ++dn) {
      uint8_t* p0 = qs + r0 * stride + col + 16 * dn + c4;
      *reinterpret_cast<uint32_t*>(p0) = pack_bf16(o[dn][0], o[dn][1]);
      *reinterpret_cast<uint32_t*>(p0 + 8 * stride) =
          pack_bf16(o[dn][2], o[dn][3]);
    }
  }
  __syncthreads();
  store_rows<1>({reinterpret_cast<uint8_t*>(out) + n * lq * row_bytes},
                row_bytes, {qs}, stride, lq, chunks, tid, nt);
}

size_t smem_bytes_bf16(int heads, int dh) {
  return 3 * (size_t)kRows * row_stride(heads * dh * 2 / 16) +
         sizeof(float) * kRows * kBiasStride;
}

// ---- any length: query tiles over the grid, key tiles streamed ----
//
// Past 32 queries or keys (either) the launch takes this kernel instead:
// a block per (batch row, tile of 32 queries), a warp per head, the keys
// streamed in tiles of 32 with an online softmax. A tile's logits are taken
// as above; the row's running max m and sum l are updated (the context and
// l rescaled by exp(m_old - m_new)) and the tile's exp(logit - m) times v
// summed into the context, which is divided by l at the end. So the
// probabilities are rounded to v's type before the division where the
// plain version rounds them after it: within one rounding of each. Rows
// and keys past the last tile's are masked (keys at -inf, their v rows
// zero; queries are computed and not written).
//
// What bounds it: memory. At N = 64, Lq = Lk = 128, 8 heads of 16 (bf16)
// a call must move 12.6 MB (q, k, v, out and the f32 bias), 0.0038 ms at
// the H100 SXM's 3.35 TB/s, against 0.54 GFLOP. It takes 0.0165 ms of
// device time on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), where
// PyTorch's scaled_dot_product_attention takes 0.0219: each block stages a
// key tile and waits for it before its products (the several blocks an
// SM holds overlap one's loads with another's products), and each tile's
// bias is read once per query tile.

// The tensor-core kernel above on a tile of 32 queries against key tiles of
// 32; the query tile's fragments are read from shared memory at each key
// tile.
template <int DH>
__global__ void __launch_bounds__(kMaxHeads * 32)
attention_fwd_mma_long_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ out, int lq,
                              int lk, int heads, float inv_scale) {
  constexpr int KS = (DH + 15) / 16;
  constexpr int NT = DH / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int row_bytes = heads * DH * 2;
  const int chunks = row_bytes / 16;
  const int stride = row_stride(chunks);
  uint8_t* qs = smem_raw;
  uint8_t* ks = qs + kRows * stride;
  uint8_t* vs = ks + kRows * stride;
  float* bs = reinterpret_cast<float*>(vs + kRows * stride);

  const long long n = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int ql = min(kRows, lq - q0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const uint8_t* qg =
      reinterpret_cast<const uint8_t*>(q) + (n * lq + q0) * row_bytes;
  stage_rows<1>({qs}, stride, {qg}, row_bytes, ql, chunks, tid, nt);
  zero_rows<1>({qs}, stride, ql, chunks, tid, nt);

  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c4 = 4 * (lane & 3);
  const int col = (tid >> 5) * DH * 2;
  const int mq = ql > 16 ? 2 : 1;

  float o[2][NT][4];
  float m[2][2], l[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mi][r] = -INFINITY;
      l[mi][r] = 0.f;
    }
#pragma unroll
    for (int dn = 0; dn < NT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][dn][e] = 0.f;
  }

  for (int k0 = 0; k0 < lk; k0 += kRows) {
    const int kl = min(kRows, lk - k0);
    __syncthreads();  // the last tile's reads are done
    const uint8_t* kg =
        reinterpret_cast<const uint8_t*>(k) + (n * lk + k0) * row_bytes;
    const uint8_t* vg =
        reinterpret_cast<const uint8_t*>(v) + (n * lk + k0) * row_bytes;
    stage_rows<2>({ks, vs}, stride, {kg, vg}, row_bytes, kl, chunks, tid,
                  nt);
    stage_bias_tile(bs, bias + (n * lq + q0) * lk + k0, ql, kl, lk, tid, nt);
    zero_rows<1>({vs}, stride, kl, chunks, tid, nt);
    cp_async_wait_all();
    __syncthreads();

    uint32_t kb[4][KS][2];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const uint8_t* kr = ks + (8 * nj + g) * stride + col + c4;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        kb[nj][s][0] = lds32(kr + 32 * s);
        kb[nj][s][1] = DH >= 16 ? lds32(kr + 32 * s + 16) : 0u;
      }
    }
    uint32_t vb[2][NT][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int dn = 0; dn < NT; ++dn)
        ldsm_x2_trans(vb[kk][dn][0], vb[kk][dn][1],
                      vs + (16 * kk + (lane & 15)) * stride + col + 16 * dn);

#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (mi >= mq) continue;
      const int r0 = 16 * mi + g;
      const uint8_t* q0p = qs + r0 * stride + col + c4;
      const uint8_t* q1p = q0p + 8 * stride;
      uint32_t qa[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        qa[s][0] = lds32(q0p + 32 * s);
        qa[s][1] = lds32(q1p + 32 * s);
        qa[s][2] = DH >= 16 ? lds32(q0p + 32 * s + 16) : 0u;
        qa[s][3] = DH >= 16 ? lds32(q1p + 32 * s + 16) : 0u;
      }
      float sc[4][4];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nj][e] = 0.f;
#pragma unroll
        for (int s = 0; s < KS; ++s)
          mma16816(sc[nj], qa[s], kb[nj][s][0], kb[nj][s][1]);
      }
      float tmax[2];
      tile_logits(sc, bs, r0, c4 >> 1, kl, inv_scale, tmax);
      float alpha[2], tsum[2] = {0.f, 0.f};
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
          sc[nj][e] = expf(sc[nj][e] - m[mi][e >> 1]);
          tsum[e >> 1] += sc[nj][e];
        }
      quad_sum(tsum);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[mi][r] = l[mi][r] * alpha[r] + tsum[r];
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* x = sc[2 * kk + half];
          pa[kk][2 * half] = pack_bf16(x[0], x[1]);
          pa[kk][2 * half + 1] = pack_bf16(x[2], x[3]);
        }
#pragma unroll
      for (int dn = 0; dn < NT; ++dn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mi][dn][e] *= alpha[e >> 1];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          mma16816(o[mi][dn], pa[kk], vb[kk][dn][0], vb[kk][dn][1]);
      }
    }
  }
  // the context / l over this warp's slice of the staged q (read for the
  // last time above)
  __syncwarp();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (mi >= mq) continue;
    const int r0 = 16 * mi + g;
#pragma unroll
    for (int dn = 0; dn < NT; ++dn) {
      uint8_t* p0 = qs + r0 * stride + col + 16 * dn + c4;
      *reinterpret_cast<uint32_t*>(p0) =
          pack_bf16(__fdiv_rn(o[mi][dn][0], l[mi][0]),
                    __fdiv_rn(o[mi][dn][1], l[mi][0]));
      *reinterpret_cast<uint32_t*>(p0 + 8 * stride) =
          pack_bf16(__fdiv_rn(o[mi][dn][2], l[mi][1]),
                    __fdiv_rn(o[mi][dn][3], l[mi][1]));
    }
  }
  __syncthreads();
  store_rows<1>({reinterpret_cast<uint8_t*>(out) + (n * lq + q0) * row_bytes},
                row_bytes, {qs}, stride, ql, chunks, tid, nt);
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
              void* out, int n, int lq, int lk, int heads, float inv_scale,
              cudaStream_t st) {
  using T = __nv_bfloat16;
  const size_t smem = smem_bytes_bf16(heads, DH);
  if (lq > kRows || lk > kRows) {
    const dim3 grid(n, (lq + kRows - 1) / kRows);
    const int err = set_smem(attention_fwd_mma_long_kernel<DH>, smem);
    if (err) return err;
    attention_fwd_mma_long_kernel<DH><<<grid, heads * 32, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out,
        lq, lk, heads, inv_scale);
    return (int)cudaGetLastError();
  }
  const int err = set_smem(attention_fwd_mma_kernel<DH>, smem);
  if (err) return err;
  attention_fwd_mma_kernel<DH><<<n, heads * 32, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out, lq,
      lk, heads, inv_scale);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int n, int lq, int lk, int heads, int dh, double scale,
           void* stream) {
  if (n <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || heads > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  // 1/scale in double, then rounded once to f32: the TPU kernel's
  // `s * (1.0 / scale)` with a Python-float scale
  const float inv_scale = (float)(1.0 / scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 8:
      return launch_dh<8>(q, k, v, bias, out, n, lq, lk, heads, inv_scale,
                          st);
    case 16:
      return launch_dh<16>(q, k, v, bias, out, n, lq, lk, heads, inv_scale,
                           st);
    case 32:
      return launch_dh<32>(q, k, v, bias, out, n, lq, lk, heads, inv_scale,
                           st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the wrapper checks this
// against the device's limit before launching).
size_t deepsc_attention_fwd_smem_bytes_bf16(int lq, int lk, int heads,
                                            int dh) {
  return smem_bytes_bf16(heads, dh);
}

// q, k, v, out: contiguous bf16 (N, L, heads*dh); bias: contiguous f32
// (N, Lq, Lk). Returns cudaGetLastError() after the launch (0 = success).
int deepsc_attention_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* bias, void* out, int n, int lq,
                              int lk, int heads, int dh, double scale,
                              void* stream) {
  return launch(q, k, v, bias, out, n, lq, lk, heads, dh, scale, stream);
}

}  // extern "C"
