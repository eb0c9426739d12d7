// Fused multi-head attention backward (K2) past 128 queries or keys, up to
// kMaxLen of both, bf16, a block per batch row's head walking its query
// slices (split over a thread-block cluster where the rows' heads are fewer
// than the SMs) (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_bwd_kernel` of deepsc_gan_tpu/ops/pallas/
// attention.py where the resident bf16 K2 (csrc/attention_bwd_resident.cu,
// up to 128 queries and keys) does not take the call: heads of 8, 16 or
// 32, at most 16 of them, more than 128 queries or keys and at most
// kMaxLen = 512 of each (`cli train --seq-len 256`: each attention's
// backward). f32, and longer rows, stay on csrc/attention_bwd.cu's
// long-length kernels. Same function as the other K2s: for each batch row
// n and head h, p recomputed as the forward computes it (f32 logits `s *
// (1/scale)` then `+ bias`, the exact row max and sum, p = e / sum), dv =
// pc^T g with pc = p rounded to bf16, dp = g v^T (f32), ds = p (dp -
// rowsum(dp p)), dq = dss k and dk = dss^T q with dss = (ds * (1/scale))
// rounded to bf16, dbias = sum over heads 0..H-1 of ds (f32).
//
// What bounds it: memory. At N = 64, Lq = Lk = 256, 8 heads of 16 (no
// dbias) a call must move 46.1 MB (q, k, v, g 16.8 MB, the f32 bias 16.8
// MB, dq, dk, dv 12.6 MB), 0.0138 ms at 3.35 TB/s, against 5.4 GFLOP. The
// design before this one (csrc/attention_bwd.cu's long-length kernels: a
// block per 32 queries streaming 32-key tiles twice, then a block per 32
// keys streaming the query tiles; the logits and dP formed three times,
// the bias tile read in every pass) took 0.2311 ms there on an H100 80GB
// HBM3 at 700 W, SDPA's backward 0.1225.
//
// Design. The resident kernel holds a row's head whole, which past 128
// does not fit a block (the f32 bias tile alone is 256 KB at 256 x 256).
// Here a block takes a row's head: it stages the head's k and v once (all
// keys, rows past Lk zeroed) and walks the queries in slices of
// 16 x 16 / chunks, at most 128 (64 at 256 keys, 32 at 512), each slice's
// q, g and f32 bias rows staged with cp.async (16-byte copies where Lk is
// a multiple of 4), the next slice's issued while the current one is
// worked (bulk copies of the bias rows by one thread were slower: the
// other warps waited for it). Phase 1, a warp per (16 queries, 64-key
// chunk): S = q k^T and dP = g v^T on the mma.sync accumulators, the
// logits `s * (1/scale) + bias`, the exponentials against the chunk's own
// row max, their sum and rowsum(dp e); the row's max, sum and rowsum(dp p)
// combined over its chunks through shared memory (one exchange), then p
// and ds; pc and dss go to (slice, Lk) bf16 tiles in shared memory, and
// dQ = dss k per chunk, the chunks' partials summed in order by the query
// group's warps and written. So p and dP are formed once for each
// query-key pair, and each bias element is read once per head. Phase 2, a
// warp per 16 keys: dV and dK accumulate in registers over the slices
// (`mrow::dkv_products`) and are written at the end. Columns past Lk hold
// a -inf bias and rows past the slice zeros, so no element is masked.
// Where rows x heads are fewer than the SMs, the slices of a row's head
// are split over a thread-block cluster of up to 8 blocks, whose dK and dV
// partials are summed through distributed shared memory in rank order.
// Every output element is written by one thread, every sum in a fixed
// order: no atomics, so two calls give the same bits. The exponentials and
// the 1/sum are the fast hardware ones (ex2.approx, a reciprocal), within
// bf16's rounding of the exact ones. dbias: each block writes its head's
// f32 ds to an (N, H, Lq, Lk) scratch and a second kernel sums the heads
// in order (`mrow::sum_dbias`). A block runs 512 threads of up to 128
// registers (one block an SM) and at most 227 KB of shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_row.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace mrow;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;         // keys of a phase-1 warp
constexpr int kMaxLen = 512;       // queries and keys
constexpr int kMaxHeads = 16;
constexpr int kMaxCluster = 8;     // blocks a cluster (portable)
constexpr int kMaxGroups = 8;      // 16-query groups of a slice
constexpr int kMaxSteps = kMaxGroups;  // query k-steps of a slice
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

// the key chunks of 64 a warp row is cut into (1, 2, 4 or 8)
__host__ __device__ __forceinline__ int key_chunks(int lk) {
  const int c = (lk + kChunk - 1) / kChunk;
  return c <= 1 ? 1 : c <= 2 ? 2 : c <= 4 ? 4 : 8;
}

// queries of a slice: a warp per (16 queries, key chunk), at most 128
// queries (the shared memory of two q and g buffers at 64 keys and fewer)
__host__ __device__ __forceinline__ int slice_rows(int lk) {
  const int groups = kWarps / key_chunks(lk);
  return 16 * (groups < kMaxGroups ? groups : kMaxGroups);
}

__host__ __device__ __forceinline__ int slices(int lq, int lk) {
  return (lq + slice_rows(lk) - 1) / slice_rows(lk);
}

// byte offsets of a block's shared memory: k, v (lkp rows), two buffers of
// a slice's q and g rows, the slice's f32 bias rows (bstride floats), the
// pc and dss tiles, the row statistics of each warp (max, sum, rowsum: 16
// rows each), and the dq partials of the warps (16 x dh f32 each), in a
// space of their own where it fits (`dqx`), else in
// the bias rows once the logits are formed (`shared_dqx`: the next slice's
// copies then wait for the dq sum); after the last slice the f32 dV and dK
// partials (lkp x dh each) from 0
constexpr int kSmemLimit = 232448;  // a block's, on the H100

struct Layout {
  int stride, pstride, bstride, lkp, rows;
  int vs, qg[2], bias, ps, dss, stat, dqx, total;
  bool shared_dqx;
};

__host__ __device__ __forceinline__ Layout layout(int lk, int dh) {
  Layout s;
  s.stride = row_stride(dh * 2 / 16);
  s.lkp = round16(lk);
  s.rows = slice_rows(lk);
  s.pstride = 2 * s.lkp + 16;
  s.bstride = s.lkp + 8;
  s.vs = s.lkp * s.stride;
  s.qg[0] = s.vs + s.lkp * s.stride;
  s.qg[1] = s.qg[0] + 2 * s.rows * s.stride;
  s.bias = s.qg[1] + 2 * s.rows * s.stride;
  s.ps = s.bias + s.rows * s.bstride * (int)sizeof(float);
  s.dss = s.ps + s.rows * s.pstride;
  s.stat = s.dss + s.rows * s.pstride;
  const int end = s.stat + 3 * kWarps * 16 * (int)sizeof(float);
  const int own =
      end + (s.rows / 16) * key_chunks(lk) * 16 * dh * (int)sizeof(float);
  s.shared_dqx = own > kSmemLimit;
  s.dqx = s.shared_dqx ? s.bias : end;
  const int main = s.shared_dqx ? end : own;
  const int red = 2 * s.lkp * dh * (int)sizeof(float);
  s.total = main > red ? main : red;
  return s;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Slice `slice`'s q and g rows into buffer qs/gs and its bias rows into bs
// (cp.async; not waited for), with the rows past lq zeroed and the bias
// columns past lk set to -inf, by the block's threads.
template <int DH>
__device__ __forceinline__ void stage_slice(
    const Layout& sl, uint8_t* qs, uint8_t* gs, float* bs,
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ bias, long long n, int head, int heads,
    int lq, int lk, int slice, int tid, int nt) {
  constexpr int chunks = DH * 2 / 16;
  const int row_bytes = heads * DH * 2;
  const int s0 = slice * sl.rows;
  const int rows = min(sl.rows, lq - s0);
  const long long at = (n * lq + s0) * row_bytes + (long long)head * DH * 2;
  stage_rows<2>({qs, gs}, sl.stride,
                {reinterpret_cast<const uint8_t*>(q) + at,
                 reinterpret_cast<const uint8_t*>(g) + at},
                row_bytes, rows, chunks, tid, nt);
  for (int c = tid; c < (sl.rows - rows) * chunks; c += nt) {
    const int o = (rows + c / chunks) * sl.stride + 16 * (c % chunks);
    *reinterpret_cast<uint4*>(qs + o) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(gs + o) = make_uint4(0, 0, 0, 0);
  }
  // the bias rows (16-byte copies where Lk is a multiple of 4; where a
  // pass of the block's threads covers whole rows, each thread keeps its
  // column), the columns past lk -inf, the rows past the slice's zero (how
  // these loops are written moves the kernel's registers and spills, and
  // its time by 3-7 %: `scripts/attention_bwd_cluster_variants.py`)
  const float* bn = bias + (n * lq + s0) * lk;
  const int per = lk / 4;
  if (lk % 4 == 0 && nt % per == 0) {
    const int j = 4 * (tid % per);
    for (int i = tid / per; i < rows; i += nt / per)
      cp_async16(bs + i * sl.bstride + j, bn + (long long)i * lk + j);
  } else if (lk % 4 == 0) {
    for (int c = tid; c < rows * per; c += nt) {
      const int i = c / per;
      const int j = 4 * (c - i * per);
      cp_async16(bs + i * sl.bstride + j, bn + (long long)i * lk + j);
    }
  } else {  // 4-byte copies, a warp a row
    for (int i = tid >> 5; i < rows; i += nt >> 5)
      for (int j = tid & 31; j < lk; j += 32)
        cp_async4(bs + i * sl.bstride + j, bn + (long long)i * lk + j);
  }
  const int pad = sl.lkp - lk;
  for (int e = tid; e < sl.rows * pad; e += nt) {
    const int i = e / pad;
    bs[i * sl.bstride + lk + (e - i * pad)] = -INFINITY;
  }
  for (int e = tid; e < (sl.rows - rows) * lk; e += nt) {
    const int i = rows + e / lk;
    bs[i * sl.bstride + (e - (i - rows) * lk)] = 0.f;
  }
}

template <int DH, int G>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_cluster_kernel(const __nv_bfloat16* __restrict__ q,
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
  constexpr int NJ = kChunk / 8;      // 8-key n-tiles of a warp's S, dP
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout sl = layout(lk, DH);
  const int stride = sl.stride;
  const int pstride = sl.pstride;
  uint8_t* ks = smem;
  uint8_t* vs = smem + sl.vs;
  float* bs = reinterpret_cast<float*>(smem + sl.bias);
  float* dqx = reinterpret_cast<float*>(smem + sl.dqx);
  uint8_t* ps = smem + sl.ps;
  uint8_t* dss = smem + sl.dss;
  float* const st[3] = {reinterpret_cast<float*>(smem + sl.stat),
                        reinterpret_cast<float*>(smem + sl.stat) + kWarps * 16,
                        reinterpret_cast<float*>(smem + sl.stat) +
                            2 * kWarps * 16};

  const int rank = blockIdx.x;  // in the cluster: the slices rank, + ranks..
  const int ranks = gridDim.x;
  const int head = blockIdx.y;
  const long long n = blockIdx.z;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int hd = heads * DH;
  const int row_bytes = hd * 2;
  constexpr int chunks = DH * 2 / 16;
  const long long k_at = n * lk * row_bytes + (long long)head * DH * 2;
  stage_rows<2>({ks, vs}, stride,
                {reinterpret_cast<const uint8_t*>(k) + k_at,
                 reinterpret_cast<const uint8_t*>(v) + k_at},
                row_bytes, lk, chunks, tid, nt);
  for (int c = tid; c < (sl.lkp - lk) * chunks; c += nt) {
    const int o = (lk + c / chunks) * stride + 16 * (c % chunks);
    *reinterpret_cast<uint4*>(ks + o) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(vs + o) = make_uint4(0, 0, 0, 0);
  }
  const int count = slices(lq, lk);
  if (rank < count)
    stage_slice<DH>(sl, smem + sl.qg[0], smem + sl.qg[0] + sl.rows * stride,
                    bs, q, g, bias, n, head, heads, lq, lk, rank, tid, nt);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;       // fragment row g
  const int c4 = 4 * (lane & 3);  // byte offset of column 2 (t % 4)
  const int c2 = 2 * (lane & 3);
  const int nkc = key_chunks(lk);
  const int used = (sl.lkp + kChunk - 1) / kChunk;  // chunks holding keys
  const int qg = warp / nkc;
  const int kc = warp % nkc;
  const int kb = kc * kChunk;
  const int kn = min(kChunk, sl.lkp - kb);  // this warp's keys (if > 0)
  const int r0 = 16 * qg + gr;  // this thread's rows r0, r0 + 8 of a slice
  const int groups = sl.lkp / 16;
  // a value of the thread's two rows over the chunks of its query group,
  // in chunk order (st[0] and st[1]: each chunk's max and its sum)
  const auto row_of = [&](const float* s, int c, int r) {
    return s[(qg * nkc + c) * 16 + gr + 8 * r];
  };

  float dva[G][NT][4], dka[G][NT][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    zero_out(dva[gi]);
    zero_out(dka[gi]);
  }
  int buf = 0;
  for (int slice = rank; slice < count; slice += ranks, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // the slice staged; the last slice's products done
    const int s0 = slice * sl.rows;
    const int rows = min(sl.rows, lq - s0);
    uint8_t* qs = smem + sl.qg[buf];
    uint8_t* gs = qs + sl.rows * stride;
    const bool active = 16 * qg < rows && kc < used;

    // ---- phase 1: a warp per 16 queries and 64 keys
    float p[NJ][4], dp[NJ][4];
    float mx[2] = {-INFINITY, -INFINITY};
    if (active) {
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
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nj][e] = dp[nj][e] = 0.f;
        if (8 * nj >= kn) continue;
        const int o = (kb + 8 * nj + gr) * stride + c4;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          mma16816(p[nj], qa[s], lds32(ks + o + 32 * s),
                   DH >= 16 ? lds32(ks + o + 32 * s + 16) : 0u);
          mma16816(dp[nj], ga[s], lds32(vs + o + 32 * s),
                   DH >= 16 ? lds32(vs + o + 32 * s + 16) : 0u);
        }
      }
      // the logits (keys past lk: a -inf bias; n-tiles past the keys too)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 b =
              8 * nj < kn ? *reinterpret_cast<const float2*>(
                                bs + (r0 + 8 * half) * sl.bstride + kb +
                                8 * nj + c2)
                          : make_float2(-INFINITY, -INFINITY);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = __fadd_rn(
                __fmul_rn(p[nj][2 * half + e], inv_scale), e ? b.y : b.x);
            p[nj][2 * half + e] = x;
            mx[half] = fmaxf(mx[half], x);
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // the exponentials against the chunk's max, their sum and
      // rowsum(dp e)
      float sum[2] = {0.f, 0.f}, dpe[2] = {0.f, 0.f};
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[nj][e] = ex2(fmaf(p[nj][e], kLog2e, -mx[e >> 1] * kLog2e));
          sum[e >> 1] += p[nj][e];
          dpe[e >> 1] = fmaf(dp[nj][e], p[nj][e], dpe[e >> 1]);
        }
      quad_sum(sum);
      quad_sum(dpe);
      if ((lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          st[0][warp * 16 + gr + 8 * r] = mx[r];
          st[1][warp * 16 + gr + 8 * r] = sum[r];
          st[2][warp * 16 + gr + 8 * r] = dpe[r];
        }
      }
    }
    __syncthreads();  // the chunks' maxima and sums; the bias read
    if (!sl.shared_dqx && slice + ranks < count)
      stage_slice<DH>(sl, smem + sl.qg[buf ^ 1],
                      smem + sl.qg[buf ^ 1] + sl.rows * stride, bs, q, g,
                      bias, n, head, heads, lq, lk, slice + ranks, tid, nt);
    if (active) {
      // over the row's chunks in order: its max m, its sum l and
      // rowsum(dp e) against m; then p = e exp(chunk max - m) / l,
      // rowsum(dp p) = that rowsum / l, ds = p (dp - rowsum(dp p))
      float scale[2], rsum[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = -INFINITY;
        for (int c = 0; c < used; ++c) m = fmaxf(m, row_of(st[0], c, r));
        float l = 0.f, dl = 0.f;
        for (int c = 0; c < used; ++c) {
          const float f = ex2((row_of(st[0], c, r) - m) * kLog2e);
          l = fmaf(row_of(st[1], c, r), f, l);
          dl = fmaf(row_of(st[2], c, r), f, dl);
        }
        const float rl = __frcp_rn(l);
        scale[r] = ex2((mx[r] - m) * kLog2e) * rl;
        rsum[r] = dl * rl;
      }
      uint32_t dsp[NJ][2];  // dss, packed: the A operand of dQ
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[nj][e] *= scale[e >> 1];
          dp[nj][e] = p[nj][e] * (dp[nj][e] - rsum[e >> 1]);
        }
        if (8 * nj >= kn) {
          dsp[nj][0] = dsp[nj][1] = 0u;
          continue;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int o = (r0 + 8 * half) * pstride + 2 * (kb + 8 * nj + c2);
          *reinterpret_cast<uint32_t*>(ps + o) =
              pack_bf16(p[nj][2 * half], p[nj][2 * half + 1]);
          dsp[nj][half] = pack_bf16(dp[nj][2 * half] * inv_scale,
                                    dp[nj][2 * half + 1] * inv_scale);
          *reinterpret_cast<uint32_t*>(dss + o) = dsp[nj][half];
        }
      }
      if (ds_out != nullptr) {
        // this head's unscaled f32 ds, summed over heads for dbias
        float* base = ds_out + ((n * heads + head) * lq + s0) * lk;
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r0 + 8 * (e >> 1);
            const int j = kb + 8 * nj + c2 + (e & 1);
            if (i < rows && j < lk) base[(long long)i * lk + j] = dp[nj][e];
          }
      }
      // dQ = dss k over the chunk's key k-steps; k the B operand
      float dqa[NT][4];
      zero_out(dqa);
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        if (16 * kk >= kn) continue;
        const uint32_t a[4] = {dsp[2 * kk][0], dsp[2 * kk][1],
                               dsp[2 * kk + 1][0], dsp[2 * kk + 1][1]};
        const uint8_t* row = ks + (kb + 16 * kk + (lane & 15)) * stride;
#pragma unroll
        for (int dn = 0; dn < NT; ++dn) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, row + 16 * dn);
          mma16816(dqa[dn], a, b0, b1);
        }
      }
      float* part = dqx + (qg * nkc + kc) * 16 * DH;
#pragma unroll
      for (int dn = 0; dn < NT; ++dn)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(part + (gr + 8 * half) * DH + 8 * dn +
                                     c2) =
              make_float2(dqa[dn][2 * half], dqa[dn][2 * half + 1]);
    }
    __syncthreads();  // the tiles and the dq partials written
    if (active) {
      // the warps of a query group sum its chunks' dq partials in chunk
      // order, a column pair a thread
      const int pairs = 16 * DH / 2;
      for (int e = kc * 32 + lane; e < pairs; e += used * 32) {
        const int i = e / (DH / 2);
        const int j = 2 * (e - i * (DH / 2));
        if (16 * qg + i >= rows) continue;
        float2 x = make_float2(0.f, 0.f);
        for (int c = 0; c < used; ++c) {
          const float2 y = *reinterpret_cast<const float2*>(
              dqx + ((qg * nkc + c) * 16 + i) * DH + j);
          x.x += y.x;
          x.y += y.y;
        }
        *reinterpret_cast<uint32_t*>(
            dq + (n * lq + s0 + 16 * qg + i) * hd + head * DH + j) =
            pack_bf16(x.x, x.y);
      }
    }
    if (sl.shared_dqx) {
      __syncthreads();  // the dq partials read: the next slice may come in
      if (slice + ranks < count)
        stage_slice<DH>(sl, smem + sl.qg[buf ^ 1],
                        smem + sl.qg[buf ^ 1] + sl.rows * stride, bs, q, g,
                        bias, n, head, heads, lq, lk, slice + ranks, tid,
                        nt);
    }

    // ---- phase 2: a warp per 16 keys, over the slice's queries
    const int nq = (rows + 15) / 16;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int kg = warp + kWarps * gi;
      if (kg < groups)
        dkv_products<NT, kMaxSteps>(dva[gi], dka[gi], ps, dss, gs, qs,
                                    stride, nq, kg, 0, lane, pstride);
    }
  }

  const long long out_at = n * lk * hd + head * DH;
  if (ranks == 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int kg = warp + kWarps * gi;
      if (kg >= groups) continue;
      store_out<NT>(dv + out_at, hd, dva[gi], lk, DH, 16 * kg + gr, c2, 0,
                    true);
      store_out<NT>(dk + out_at, hd, dka[gi], lk, DH, 16 * kg + gr, c2, 0,
                    true);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // every read of the tiles done: the partials replace them
  float* red_v = reinterpret_cast<float*>(smem);
  float* red_k = red_v + sl.lkp * DH;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int kg = warp + kWarps * gi;
    if (kg >= groups) continue;
#pragma unroll
    for (int dn = 0; dn < NT; ++dn)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = (16 * kg + gr + 8 * half) * DH + 8 * dn + c2;
        *reinterpret_cast<float2*>(red_v + o) =
            make_float2(dva[gi][dn][2 * half], dva[gi][dn][2 * half + 1]);
        *reinterpret_cast<float2*>(red_k + o) =
            make_float2(dka[gi][dn][2 * half], dka[gi][dn][2 * half + 1]);
      }
  }
  cluster.sync();  // every block's partials written
  // this block's share of the keys' column pairs, summed over the
  // cluster's blocks in rank order through distributed shared memory
  const int pairs = lk * (DH / 2);
  const int per = (pairs + ranks - 1) / ranks;
  const int first = rank * per;
  const int last = min(pairs, first + per);
  for (int e = first + tid; e < last; e += nt) {
    const int key = e / (DH / 2);
    const int o = key * DH + 2 * (e - key * (DH / 2));
    float2 sv = make_float2(0.f, 0.f), sk = make_float2(0.f, 0.f);
    for (int r = 0; r < ranks; ++r) {
      const float2 yv = *reinterpret_cast<const float2*>(
          cluster.map_shared_rank(red_v, r) + o);
      const float2 yk = *reinterpret_cast<const float2*>(
          cluster.map_shared_rank(red_k, r) + o);
      sv.x += yv.x;
      sv.y += yv.y;
      sk.x += yk.x;
      sk.y += yk.y;
    }
    const long long at = out_at + (long long)key * hd + (o - key * DH);
    *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(sv.x, sv.y);
    *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(sk.x, sk.y);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <int DH, int G>
const void* kernel_of() {
  return (const void*)attention_bwd_cluster_kernel<DH, G>;
}

// the instance for head width dh and lk keys (null where none is built):
// G phase-2 key groups of 16 a warp
const void* pick(int dh, int lk) {
  const bool one = round16(lk) <= 16 * kWarps;
  switch (dh) {
    case 8:
      return one ? kernel_of<8, 1>() : kernel_of<8, 2>();
    case 16:
      return one ? kernel_of<16, 1>() : kernel_of<16, 2>();
    case 32:
      return one ? kernel_of<32, 1>() : kernel_of<32, 2>();
    default:
      return nullptr;
  }
}

bool takes(int lq, int lk, int heads, int dh) {
  return lq >= 1 && lq <= kMaxLen && lk >= 1 && lk <= kMaxLen &&
         heads >= 1 && heads <= kMaxHeads && pick(dh, lk) != nullptr;
}

// the blocks of a cluster: doubled, up to kMaxCluster and the slices,
// while the rows' heads times it are fewer than the SMs
int cluster_size(int n, int heads, int lq, int lk, int sms) {
  int c = 1;
  while (2 * c <= kMaxCluster && 2 * c <= slices(lq, lk) &&
         (long long)n * heads * c < sms)
    c *= 2;
  return c;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int sm_count(int* sms) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  return err;
}

}  // namespace

extern "C" {

// The block at Lq x Lk and head width dh, into out[4]: its dynamic shared
// memory in bytes, its threads, the query slices of a row's head, and the
// queries of a slice. 0 on success, else a CUDA error
// (cudaErrorInvalidValue for a shape the library does not take).
int deepsc_attention_bwd_cluster_plan(int lq, int lk, int dh, int* out) {
  if (!takes(lq, lk, 1, dh)) return (int)cudaErrorInvalidValue;
  const Layout sl = layout(lk, dh);
  out[0] = sl.total;
  out[1] = kThreads;
  out[2] = slices(lq, lk);
  out[3] = sl.rows;
  return set_smem(pick(dh, lk), sl.total);
}

// The blocks of a cluster at N rows and heads heads (1 where the rows'
// heads fill the current device's SMs), into *out; 0 or a CUDA error.
int deepsc_attention_bwd_cluster_size(int n, int heads, int lq, int lk,
                                      int* out) {
  if (n <= 0 || !takes(lq, lk, heads, 16)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = sm_count(&sms);
  if (!err) *out = cluster_size(n, heads, lq, lk, sms);
  return err;
}

// q, g, dq: contiguous bf16 (N, Lq, heads*dh); k, v, dk, dv: (N, Lk,
// heads*dh); bias: contiguous f32 (N, Lq, Lk), 16-byte aligned; dh 8, 16
// or 32, heads <= 16, Lq and Lk <= 512; dbias: f32 (N, Lq, Lk) or null,
// and then ds: the caller's f32 scratch (N, heads, Lq, Lk). Returns
// cudaGetLastError() after the launches (0 = success).
int deepsc_attention_bwd_cluster_bf16(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* g, void* dq, void* dk,
                                      void* dv, void* dbias, void* ds,
                                      int n, int lq, int lk, int heads,
                                      int dh, double scale, void* stream) {
  if (n <= 0 || n > 65535 || !takes(lq, lk, heads, dh) ||
      (dbias != nullptr && !ds))
    return (int)cudaErrorInvalidValue;
  // 1/scale in double, rounded once to f32, as the forward
  const float inv_scale = (float)(1.0 / scale);
  cudaStream_t st = (cudaStream_t)stream;
  const void* kernel = pick(dh, lk);
  const Layout sl = layout(lk, dh);
  int sms = 0;
  int err = sm_count(&sms);
  if (!err) err = set_smem(kernel, sl.total);
  if (err) return err;
  const int cluster = cluster_size(n, heads, lq, lk, sms);
  float* ds_out = dbias != nullptr ? (float*)ds : nullptr;
  void* args[] = {(void*)&q,  (void*)&k,  (void*)&v,      (void*)&bias,
                  (void*)&g,  (void*)&dq, (void*)&dk,     (void*)&dv,
                  (void*)&ds_out, (void*)&lq, (void*)&lk, (void*)&heads,
                  (void*)&inv_scale};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, heads, n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sl.total;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelExC(&cfg, kernel, args);
  if (err) return err;
  if (dbias != nullptr)
    return sum_dbias((const float*)ds, (float*)dbias, n, heads, lq, lk, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
