// Fused beam-candidate scorer at any k and any width D, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_topk_kernel` of deepsc_gan_tpu/ops/pallas/
// topk.py where the tuned kernel (csrc/topk.cu: a sorted list of at most 8
// candidates a row in registers, D a multiple of 8 up to 256) does not take
// the call: the JAX kernel takes any k (`_take_top`, topk.py:76) and any D,
// so `--beam-size 9`, 16 or 64 and `--decoder-d-model 512` run here in
// f32, and in bf16 past k = 64 (bf16 up to 64: csrc/topk_wide_mma.cu). Same
// function as the tuned kernel: per row of h (N, D) over the vocab table W
// (V, D) of one type T and bias b (V) f32, the k largest logits h . W_v +
// b_v in descending order, ties to the lowest vocab index (k rounds of
// max, then the lowest index reaching it, the winner masked), their
// indices, and the row's logsumexp, with f32 products (exact for bf16
// operands) and f32 sums.
//
// What bounds it: the logits' f32 products on the CUDA cores and their
// round trip through device memory (a simple kernel, right first). At N =
// 256 rows (64 sequences x 4 beams), D = 128, V = 22,234, k = 16 the
// logits are 1.5 GFLOP and 22.8 MB written and read back.
//
// Design, three kernels: (1) block (row tile of 64, vocab split) computes
// its tiles of logits as the CE kernels do (csrc/wide_tile.cuh, D streamed
// in chunks), writes them to the caller's (N, V) f32 workspace and keeps a
// running (max, sum of exponentials) per row, one pair per (split, row);
// (2) block (row, split) takes its range's top k in k rounds of a block
// argmax over (value, index) with the lowest index winning a tie, each
// winner masked in the workspace before the next round, into a per-split
// list (padded with (NEG, 2^30) where the range holds fewer than k); (3)
// block (row) merges the splits' lists the same way, and the splits'
// (max, sum) pairs in order into the logsumexp. The k largest of the row
// under that order are among the k largest of their split, so the merge
// gives the plain version's list. No atomics: the same bits on every call.
// The kernels allocate nothing; the caller passes the outputs and the
// workspaces.

#include "wide_tile.cuh"

#include <math.h>

namespace {

using wide::kThreads;
using wide::NEG;
using wide::TN;
using wide::TV;

constexpr int kBig = 1 << 30;
constexpr int kSelect = 256;  // threads of the selection kernels

// ---- (1) logits and the splits' softmax sums ----

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_wide_logits_kernel(const T* __restrict__ h, const T* __restrict__ w,
                        const float* __restrict__ b,
                        float* __restrict__ logits,
                        float* __restrict__ part_ms, int n, int d, int v,
                        int tiles_per_split) {
  __shared__ float hs[TN * wide::kCStride];
  __shared__ float ws[TV * wide::kCStride];
  __shared__ float red[2 * TN * 16];

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * TN;
  const int split = blockIdx.y;
  const int nvt = (v + TV - 1) / TV;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, nvt);

  float m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    s[i] = 0.f;
  }
  for (int t = t0; t < t1; ++t) {
    const int col0 = t * TV;
    float acc[4][4];
    wide::tile_logits(h, w, n, v, d, row0, col0, hs, ws, ty, tx, acc);
    if (col0 + tx >= v) continue;  // this thread owns no column of the tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      float cm = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c < v) {
          acc[i][j] += b[c];
          cm = fmaxf(cm, acc[i][j]);
          if (r < n) logits[(size_t)r * v + c] = acc[i][j];
        }
      }
      const float mn = fmaxf(m[i], cm);
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col0 + tx + 16 * j < v) se += expf(acc[i][j] - mn);
      s[i] = s[i] * expf(m[i] - mn) + se;
      m[i] = mn;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    red[(0 * TN + r) * 16 + tx] = m[i];
    red[(1 * TN + r) * 16 + tx] = s[i];
  }
  __syncthreads();
  if (threadIdx.x < TN && row0 + (int)threadIdx.x < n) {
    const int r = threadIdx.x;
    float mm = NEG;
    for (int x = 0; x < 16; ++x) mm = fmaxf(mm, red[(0 * TN + r) * 16 + x]);
    float ss = 0.f;
    for (int x = 0; x < 16; ++x)
      ss += red[(1 * TN + r) * 16 + x] * expf(red[(0 * TN + r) * 16 + x] - mm);
    float* out = part_ms + ((size_t)split * n + row0 + r) * 2;
    out[0] = mm;
    out[1] = ss;
  }
}

// ---- block argmax over (value, index) ----

// whether (va, ia) goes before (vb, ib): the larger value, then the lower
// index
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// the block's first (value, index) pair in that order, on every thread
__device__ __forceinline__ void block_best(float& val, int& idx,
                                           float* sv, int* si) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, val, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (before(ov, oi, val, idx)) {
      val = ov;
      idx = oi;
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sv[warp] = val;
    si[warp] = idx;
  }
  __syncthreads();
  val = sv[0];
  idx = si[0];
  for (int x = 1; x < kSelect / 32; ++x)
    if (before(sv[x], si[x], val, idx)) {
      val = sv[x];
      idx = si[x];
    }
  __syncthreads();  // sv, si free for the next round
}

// ---- (2) each split's top k ----

// block (row, split): k rounds over the split's range of the row's logits,
// each winner set to NEG in the workspace (and so skipped; a range of
// fewer than k logits pads its list)
__global__ void __launch_bounds__(kSelect)
topk_wide_split_kernel(float* __restrict__ logits, float* __restrict__ part_v,
                       int* __restrict__ part_i, int n, int v, int k,
                       int tiles_per_split) {
  __shared__ float sv[kSelect / 32];
  __shared__ int si[kSelect / 32];
  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int c0 = split * tiles_per_split * TV;
  const int c1 = min(c0 + tiles_per_split * TV, v);
  float* x = logits + (size_t)row * v;
  float* out_v = part_v + ((size_t)split * n + row) * k;
  int* out_i = part_i + ((size_t)split * n + row) * k;
  for (int r = 0; r < k; ++r) {
    if (r >= c1 - c0) {  // the range is spent (the same on every thread)
      if (threadIdx.x == 0) {
        out_v[r] = NEG;
        out_i[r] = kBig;
      }
      continue;
    }
    float val = -INFINITY;
    int idx = kBig;
    for (int c = c0 + threadIdx.x; c < c1; c += kSelect) {
      // the taken are marked NEG; a logit is never below NEG
      if (x[c] != NEG && before(x[c], c, val, idx)) {
        val = x[c];
        idx = c;
      }
    }
    block_best(val, idx, sv, si);
    if (threadIdx.x == 0) {
      out_v[r] = val;
      out_i[r] = idx;
      x[idx] = NEG;
    }
    __syncthreads();  // the mark seen before the next round's reads
  }
}

// ---- (3) the merge ----

// block (row): k rounds over the splits' lists (each winner taken out by
// index), and the logsumexp from the splits' (max, sum) in order
__global__ void __launch_bounds__(kSelect)
topk_wide_merge_kernel(float* __restrict__ part_v, int* __restrict__ part_i,
                       const float* __restrict__ part_ms,
                       float* __restrict__ vals, int* __restrict__ idx_out,
                       float* __restrict__ lse, int n, int k, int splits) {
  __shared__ float sv[kSelect / 32];
  __shared__ int si[kSelect / 32];
  const int row = blockIdx.x;
  const int count = splits * k;
  for (int r = 0; r < k; ++r) {
    float val = -INFINITY;
    int idx = kBig;
    int slot = -1;
    for (int e = threadIdx.x; e < count; e += kSelect) {
      const int sp = e / k;
      const size_t at = ((size_t)sp * n + row) * k + (e - sp * k);
      if (part_i[at] != kBig && before(part_v[at], part_i[at], val, idx)) {
        val = part_v[at];
        idx = part_i[at];
        slot = e;
      }
    }
    const int mine = idx;
    block_best(val, idx, sv, si);
    if (mine == idx && slot >= 0) {  // the winner's owner takes it out
      const int sp = slot / k;
      part_i[((size_t)sp * n + row) * k + (slot - sp * k)] = kBig;
    }
    if (threadIdx.x == 0) {
      vals[(size_t)row * k + r] = val;
      idx_out[(size_t)row * k + r] = idx;
    }
    __syncthreads();  // the winner taken out before the next round's reads
  }
  if (threadIdx.x == 0) {
    float mm = NEG;
    for (int sp = 0; sp < splits; ++sp)
      mm = fmaxf(mm, part_ms[((size_t)sp * n + row) * 2]);
    float ss = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* p = part_ms + ((size_t)sp * n + row) * 2;
      ss += p[1] * expf(p[0] - mm);
    }
    lse[row] = mm + logf(ss);
  }
}

template <typename T>
int launch(const void* h, const void* w, const void* b, void* vals,
           void* idx, void* lse, void* logits, void* part_v, void* part_i,
           void* part_ms, int n, int d, int v, int k, int splits,
           void* stream) {
  const int tps = wide::split_tiles(n, d, v, splits);
  if (tps < 0 || k < 1 || k > v) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  topk_wide_logits_kernel<T><<<dim3((n + TN - 1) / TN, splits), kThreads, 0,
                               st>>>((const T*)h, (const T*)w,
                                     (const float*)b, (float*)logits,
                                     (float*)part_ms, n, d, v, tps);
  int err = (int)cudaGetLastError();
  if (err) return err;
  topk_wide_split_kernel<<<dim3(n, splits), kSelect, 0, st>>>(
      (float*)logits, (float*)part_v, (int*)part_i, n, v, k, tps);
  err = (int)cudaGetLastError();
  if (err) return err;
  topk_wide_merge_kernel<<<n, kSelect, 0, st>>>(
      (float*)part_v, (int*)part_i, (const float*)part_ms, (float*)vals,
      (int*)idx, (float*)lse, n, k, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (rows of h per tile, vocab rows per tile, blocks of the logits kernel per
// SM) into out[3], on the current device: what the wrapper cuts the vocab
// into splits by.
int deepsc_topk_wide_tiling_f32(int d, int* out) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  return wide::tiling((const void*)topk_wide_logits_kernel<float>, out);
}

int deepsc_topk_wide_tiling_bf16(int d, int* out) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  return wide::tiling((const void*)topk_wide_logits_kernel<__nv_bfloat16>,
                      out);
}

// h: contiguous (N, D), any D >= 1; w: contiguous (V, D) of h's type; b:
// f32 (V); 1 <= k <= V. Outputs vals f32 (N, k), idx int32 (N, k), lse f32
// (N). Workspaces: logits f32 (N, V); part_v f32 and part_i int32 (splits,
// N, k); part_ms f32 (splits, N, 2). Every split must own at least one vocab
// tile of 64 rows. Returns cudaGetLastError() after the launches (0 =
// success).
int deepsc_topk_wide_f32(const void* h, const void* w, const void* b,
                         void* vals, void* idx, void* lse, void* logits,
                         void* part_v, void* part_i, void* part_ms, int n,
                         int d, int v, int k, int splits, void* stream) {
  return launch<float>(h, w, b, vals, idx, lse, logits, part_v, part_i,
                       part_ms, n, d, v, k, splits, stream);
}

int deepsc_topk_wide_bf16(const void* h, const void* w, const void* b,
                          void* vals, void* idx, void* lse, void* logits,
                          void* part_v, void* part_i, void* part_ms, int n,
                          int d, int v, int k, int splits, void* stream) {
  return launch<__nv_bfloat16>(h, w, b, vals, idx, lse, logits, part_v,
                               part_i, part_ms, n, d, v, k, splits, stream);
}

}  // extern "C"
