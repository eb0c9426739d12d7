// Fused beam-candidate scorer for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_topk_kernel` of deepsc_gan_tpu/ops/pallas/topk.py
// (reached through `topk_logits`, once per beam-search decode step). For each
// row n of h (N, D), over the vocab table W (V, D) and bias b (V):
//     logits_v = h_n . W_v + b_v           (f32 products and sums of operands
//                                           in h's type, f32 or bf16)
//     vals, idx = the k largest logits, descending, ties to the lowest v
//     lse = m + log(sum_v exp(logits_v - m)),  m = max_v logits_v
// The (N, V) logits never reach device memory.
//
// What bounds it: at the CLI's beam (N = 64 x 4 = 256, D = 128, V = 22,234,
// bf16) the 5.7 MB stream of W (1.7 us at 3.35 TB/s), just above the 1.46
// GFLOP of the products at the bf16 tensor-core rate (1.5 us); at the beam
// sweep (N = 19 x 256 = 4,864) the 27.7 GFLOP (28 us). In f32 on the CUDA
// cores the products alone: 0.022 ms at the beam, 0.413 at the sweep (67
// TFLOP/s).
//
// Design: the TPU kernel walks the vocab tiles in order on one core, keeping
// a running top-k and an online max and sum. Here blocks run in parallel, so
// the vocab axis is cut into `splits` contiguous ranges (as the CE kernels:
// the wrapper takes the most splits whose blocks fit one wave, from the
// tiles and blocks per SM that `deepsc_topk_tiling_*` reports). Block
// (row tile, split) keeps its rows of h and walks its range of vocab
// tiles; each thread keeps, for each row it holds, a sorted list of its
// best L candidates, ordered by (value descending, index ascending), and a
// running (max, sum of exponentials) is kept for each row. L, the list's
// length, is the smallest of 1, 2, 4, 8 that holds k (a template), so a
// k = 4 call carries 4. A thread visits its columns of a vocab tile in
// increasing order, so a new logit enters its list only if it is larger
// than the list's last entry (an equal one has the larger index), and then
// by a shift that needs no index compare. The lists of a row's threads are
// merged once per block by shuffles; one list and one (max, sum) per
// (split, row) go to a workspace. A second kernel, a warp per row, merges
// the splits' lists and sums and writes the first k of the list and lse.
// Because the order is total and every index is seen by one thread only,
// the merged list is the same whatever the merge order: ties go to the
// lowest index exactly as the TPU kernel's masked argmax does. The sums
// are merged in a fixed tree, so the result is deterministic. No atomics.
// Vocab columns past V enter neither a list nor a sum. Each dtype has one
// partial kernel:
// - bf16, tensor cores (csrc/wgmma_tile.cuh), the logits tile of K3's
//   forward (csrc/ce_fwd.cu): one warpgroup per block, the h tile resident
//   in 128-byte-swizzled shared memory, vocab tiles of 128 rows of W
//   through a two-stage TMA ring, wgmma m64n128k16 over D with f32
//   accumulators. A thread holds rows r and r + 8 and, of each vocab tile,
//   columns 8 q + 2 (lane % 4) + e; a logit enters its list only if it is
//   also not below the quad's largest last entry (taken once a tile by two
//   shuffles). These checks still cost about as much as the softmax sums:
//   with no lists the kernel takes half its time (H100, N = 4,864,
//   scripts/kernel_variants.py). The four threads of a row (a quad) are
//   merged once per block; the running (max, sum) is per thread. Vocab
//   columns past V (the TMA zero-fills W's rows there) are set to -inf in
//   the last tile. D a multiple of 8 up to 256: the TMA zero-fills the
//   columns past D, so a last k-step of 8 adds zeros.
// - f32, CUDA cores (exact f32 products, which the f32 beam id checks
//   need): the 128 x 128 tile of the f32 K3 and K4 (csrc/ce_tiled.cuh),
//   block (128 rows of h, vocab split), 8 x 8 logits a thread, D streamed
//   in chunks of 16 columns (the next chunk loaded while this one is
//   multiplied), every logit summed over d in order 0..D-1 by fmaf and then
//   rounded once more by the bias add (the order of the tiled K3 and of
//   the 64 x 64 design before this one, so the logits are the same bits).
//   A row's 128 columns of a tile lie with the 16 threads of a half-warp:
//   the row's running (max, sum) in shared memory is rescaled per tile as
//   the tiled K3 does (the half-warp's max, then its sum of exponentials,
//   by xor shuffles in the order 1, 2, 4, 8), and each thread keeps a list
//   of L for each of its 8 rows (64 registers at L = 4: one block of 256
//   an SM). A logit enters only if it is above its own list's last entry
//   (a row threshold shared by the 16 lists, a half-warp max a tile, took
//   2-4 % longer on an H100: scripts/kernel_variants.py). The 16 threads
//   of a row merge their lists once per block
//   by a butterfly of bitonic merges of two sorted lists (L + L log2(L) /
//   2 compare-exchanges a step where insertion takes L^2: 20 against 64 at
//   L = 8). The design before this one, a 64 x 64 tile with 4 x 4 logits a
//   thread (one shared-memory load for every four FMAs), took 2.35 ms at
//   the sweep on an H100 80GB HBM3 at 700 W (PERF.md).

#include <math_constants.h>

#include "ce_tile.cuh"
#include "ce_tiled.cuh"
#include "wgmma_tile.cuh"

namespace {

using ce::NEG;

constexpr int kMaxK = 8;     // candidates kept per row (k <= 8)
constexpr int kBig = 1 << 30;

// a before b in the order of the result: value descending, index ascending
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// insert (v, i) into the sorted list (lv, li), dropping its last entry: one
// compare-and-swap pass with every index known at compile time, so the list
// stays in registers
template <int L>
__device__ __forceinline__ void insert(float (&lv)[L], int (&li)[L], float v,
                                       int i) {
  if (!before(v, i, lv[L - 1], li[L - 1])) return;
#pragma unroll
  for (int t = 0; t < L; ++t) {
    if (before(v, i, lv[t], li[t])) {
      const float tv = lv[t];
      const int ti = li[t];
      lv[t] = v;
      li[t] = i;
      v = tv;
      i = ti;
    }
  }
}

// insert (v, i) into the sorted list (lv, li) when i is above every index
// in it (a thread's own columns, which come in increasing order) and v
// above its last value: entries from v's place on move down one, each
// step reading only the old list, so v goes after every equal value
template <int L>
__device__ __forceinline__ void insert_new(float (&lv)[L], int (&li)[L],
                                           float v, int i) {
#pragma unroll
  for (int t = L - 1; t > 0; --t) {
    const bool up = v > lv[t - 1];
    const bool here = v > lv[t];
    lv[t] = up ? lv[t - 1] : (here ? v : lv[t]);
    li[t] = up ? li[t - 1] : (here ? i : li[t]);
  }
  if (v > lv[0]) {
    lv[0] = v;
    li[0] = i;
  }
}

template <int L>
__device__ __forceinline__ void clear(float (&lv)[L], int (&li)[L]) {
#pragma unroll
  for (int t = 0; t < L; ++t) {
    lv[t] = -CUDART_INF_F;
    li[t] = kBig;
  }
}

// (m, s) <- the merge of two partial (max, sum of exp(x - max))
__device__ __forceinline__ void merge_ms(float& m, float& s, float m2,
                                         float s2) {
  const float mm = fmaxf(m, m2);
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

// The best L of the sorted lists (lv, li) and (ov, oi), sorted, into (lv,
// li): the better of entry t and the other's entry L - 1 - t (a bitonic
// sequence holding the best L), then a bitonic merge: L + L log2(L) / 2
// compare-exchanges where insertion takes L^2 compare-and-swaps.
template <int L>
__device__ __forceinline__ void merge_sorted(float (&lv)[L], int (&li)[L],
                                             const float (&ov)[L],
                                             const int (&oi)[L]) {
#pragma unroll
  for (int t = 0; t < L; ++t) {
    if (before(ov[L - 1 - t], oi[L - 1 - t], lv[t], li[t])) {
      lv[t] = ov[L - 1 - t];
      li[t] = oi[L - 1 - t];
    }
  }
#pragma unroll
  for (int j = L / 2; j > 0; j /= 2) {
#pragma unroll
    for (int t = 0; t < L; ++t) {
      if ((t & j) == 0 && before(lv[t + j], li[t + j], lv[t], li[t])) {
        const float tv = lv[t];
        const int ti = li[t];
        lv[t] = lv[t + j];
        li[t] = li[t + j];
        lv[t + j] = tv;
        li[t + j] = ti;
      }
    }
  }
}

// merge the lists and sums of the lanes `lane ^ o` for o < width (a
// butterfly over `width` consecutive lanes of a warp)
template <int L>
__device__ __forceinline__ void merge_lanes(float (&lv)[L], int (&li)[L],
                                            float& m, float& s, int width) {
  for (int o = width / 2; o > 0; o /= 2) {
    float ov[L];
    int oi[L];
#pragma unroll
    for (int t = 0; t < L; ++t) {
      ov[t] = __shfl_xor_sync(0xffffffffu, lv[t], o);
      oi[t] = __shfl_xor_sync(0xffffffffu, li[t], o);
    }
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
    for (int t = 0; t < L; ++t) insert(lv, li, ov[t], oi[t]);
    merge_ms(m, s, om, os);
  }
}

// one (split, row)'s list and (max, sum) into the workspace (stride L)
template <int L>
__device__ __forceinline__ void put(const float (&lv)[L], const int (&li)[L],
                                    float m, float s, float* part_v,
                                    int* part_i, float* part_ms, size_t o) {
#pragma unroll
  for (int t = 0; t < L; ++t) {
    part_v[o * L + t] = lv[t];
    part_i[o * L + t] = li[t];
  }
  part_ms[o * 2] = m;
  part_ms[o * 2 + 1] = s;
}

// ---- f32: CUDA cores, the 128 x 128 tile ----

// block (row tile of 128, vocab split): each row's best L candidates and
// (max, sum) over the split's vocab tiles of 128, into the workspace
template <int L>
__global__ void __launch_bounds__(tiled::kThreads, 1)
topk_tiled_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ part_v,
                  int* __restrict__ part_i, float* __restrict__ part_ms,
                  int n, int d, int v, int tiles_per_split) {
  using tiled::at;
  using tiled::kBM;
  using tiled::kBN;
  __shared__ __align__(16) float as[2][tiled::kBK][tiled::kStride];
  __shared__ __align__(16) float bs[2][tiled::kBK][tiled::kStride];
  __shared__ float m_s[kBM];
  __shared__ float s_s[kBM];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int vt = (v + kBN - 1) / kBN;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, vt);
  if (threadIdx.x < kBM) {
    m_s[threadIdx.x] = NEG;
    s_s[threadIdx.x] = 0.f;
  }  // read after tile_product's first barrier
  float lv[8][L];
  int li[8][L];
#pragma unroll
  for (int i = 0; i < 8; ++i) clear(lv[i], li[i]);
  tiled::DepthAlongRows<float> la{h, n, d, d, row0};
  for (int t = t0; t < t1; ++t) {
    const int col0 = t * kBN;
    tiled::DepthAlongRows<float> lb{w, v, d, d, col0};
    float acc[8][8];
    tiled::tile_product<float>(acc, la, lb, 0, d, as, bs, tiled::Nothing{});
    float bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + at(tx, j);
      bias[j] = c < v ? __ldg(b + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float cm = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = __fadd_rn(acc[i][j], bias[j]);
        if (col0 + at(tx, j) < v) cm = fmaxf(cm, acc[i][j]);
      }
      const float m_old = m_s[at(ty, i)];
      const float mn = fmaxf(m_old, tiled::half_warp_max(cm));
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (col0 + at(tx, j) < v)
          se = __fadd_rn(se, expf(__fsub_rn(acc[i][j], mn)));
      se = tiled::half_warp_sum(se);
      // every lane read m_s before the shuffles that lane 0 waits on
      if (tx == 0) {
        s_s[at(ty, i)] = __fadd_rn(
            __fmul_rn(s_s[at(ty, i)], expf(__fsub_rn(m_old, mn))), se);
        m_s[at(ty, i)] = mn;
      }
      // the thread's columns come in increasing order, so a logit equal to
      // its list's last entry has the larger index and stays out
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + at(tx, j);
        if (c < v && acc[i][j] > lv[i][L - 1])
          insert_new(lv[i], li[i], acc[i][j], c);
      }
    }
  }
  // the 16 threads of a row are lanes 16 (ty & 1) .. + 15 of a warp,
  // merged by a butterfly; its (max, sum) is its first thread's own
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o /= 2) {
      float ov[L];
      int oi[L];
#pragma unroll
      for (int t = 0; t < L; ++t) {
        ov[t] = __shfl_xor_sync(0xffffffffu, lv[i][t], o);
        oi[t] = __shfl_xor_sync(0xffffffffu, li[i][t], o);
      }
      merge_sorted(lv[i], li[i], ov, oi);
    }
    const int row = row0 + at(ty, i);
    if (tx == 0 && row < n)
      put(lv[i], li[i], m_s[at(ty, i)], s_s[at(ty, i)], part_v, part_i,
          part_ms, (size_t)split * n + row);
  }
}

// ---- bf16: tensor cores ----

constexpr int kTV16 = 128;   // vocab rows per tile: wgmma N
constexpr int kStages = 2;   // ring of vocab tiles

// Folds the logits acc (64 x 128 accumulator of the vocab tile whose
// column c0 + 8 q + e this thread holds as acc[4 q + 2 i + e] for its rows
// i = 0, 1) into the thread's running max, sum and lists: the bias added in
// place, columns from `lim` on (a ragged last tile) set to -inf.
template <int L, bool kRagged>
__device__ __forceinline__ void fold(float (&acc)[64], const float (&bias)[32],
                                     int c0, int lim, float (&m)[2],
                                     float (&s)[2], float (&lv)[2][L],
                                     int (&li)[2][L]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float cm = NEG;
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = acc[4 * q + 2 * i + e];
        x += bias[2 * q + e];
        if (kRagged && c0 + 8 * q + e >= lim) x = -INFINITY;
        cm = fmaxf(cm, x);
      }
    const float mn = fmaxf(m[i], cm);
    const float mn2 = mn * wg::kLog2e;
    float se = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        se += wg::exp2_approx(fmaf(acc[4 * q + 2 * i + e], wg::kLog2e, -mn2));
    s[i] = s[i] * wg::exp2_approx((m[i] - mn) * wg::kLog2e) + se;
    m[i] = mn;
    // a logit below the last entry of any list of the row's quad has L
    // larger ones in that list and cannot be among the row's best L
    float tq = lv[i][L - 1];
    tq = fmaxf(tq, __shfl_xor_sync(0xffffffffu, tq, 1));
    tq = fmaxf(tq, __shfl_xor_sync(0xffffffffu, tq, 2));
    // columns come in increasing order, so a logit equal to the last entry
    // has the larger index and stays out
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = acc[4 * q + 2 * i + e];
        if (x >= tq && x > lv[i][L - 1])
          insert_new(lv[i], li[i], x, c0 + 8 * q + e);
      }
  }
}

template <int L>
__global__ void __launch_bounds__(wg::kThreads)
topk_wgmma_kernel(const __grid_constant__ CUtensorMap hmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ b, float* __restrict__ part_v,
                  int* __restrict__ part_i, float* __restrict__ part_ms,
                  int n, int d, int v, int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[kStages + 1];  // the ring's stages, then h
  uint8_t* hs = wg::align_1024(smem_raw);
  uint8_t* ring = hs + wg::tile_bytes(wg::kRows, d);
  const int stage_bytes = wg::tile_bytes(kTV16, d);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * wg::kRows;
  const int split = blockIdx.y;
  const int nvt = (v + kTV16 - 1) / kTV16;
  const int t0 = split * tiles_per_split;
  const int count = min(t0 + tiles_per_split, nvt) - t0;

  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) wg::mbar_init(&bar[i], 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    wg::load_tile(hs, &hmap, &bar[kStages], row0, wg::kRows, d);
    for (int i = 0; i < kStages && i < count; ++i)
      wg::load_tile(ring + i * stage_bytes, &wmap, &bar[i],
                    (t0 + i) * kTV16, kTV16, d);
  }

  float m[2] = {NEG, NEG}, s[2] = {0.f, 0.f};
  float lv[2][L];
  int li[2][L];
  clear(lv[0], li[0]);
  clear(lv[1], li[1]);

  wg::mbar_wait(&bar[kStages], 0);
  const uint32_t h_addr = wg::smem_u32(hs);
  for (int it = 0; it < count; ++it) {
    const int col0 = (t0 + it) * kTV16;
    const int c0 = col0 + 2 * (lane & 3);
    float bias[32];  // 8-byte loads (c0 is even) but on a ragged tile
    if (col0 + kTV16 <= v) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(c0 + 8 * q + b));
        bias[2 * q] = x.x;
        bias[2 * q + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * q + e;
          bias[2 * q + e] = c < v ? __ldg(b + c) : 0.f;
        }
    }
    uint8_t* ws = ring + (it % kStages) * stage_bytes;
    wg::mbar_wait(&bar[it % kStages], (it / kStages) & 1);
    float acc[64];
    wg::logits<kTV16, wg::kMaxSlabs>(acc, h_addr, wg::smem_u32(ws), d);
    __syncthreads();  // every warp's products have read the stage
    if (tid == 0 && it + kStages < count)
      wg::load_tile(ws, &wmap, &bar[it % kStages],
                    (t0 + it + kStages) * kTV16, kTV16, d);
    if (col0 + kTV16 <= v)
      fold<L, false>(acc, bias, c0, v, m, s, lv, li);
    else
      fold<L, true>(acc, bias, c0, v, m, s, lv, li);
  }

  // merge the four threads of each row (lanes 4 g .. 4 g + 3), in the same
  // butterfly order in every run
  const int r = (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    merge_lanes(lv[i], li[i], m[i], s[i], 4);
    const int row = row0 + r + 8 * i;
    if ((lane & 3) == 0 && row < n)
      put(lv[i], li[i], m[i], s[i], part_v, part_i, part_ms,
          (size_t)split * n + row);
  }
}

// ---- both: the splits merged ----

// a warp per row: lane l merges splits l, l + 32, ... in order, then the
// lanes are merged by a butterfly; lane 0 writes the first k and lse
template <int L>
__global__ void topk_combine_kernel(const float* __restrict__ part_v,
                                    const int* __restrict__ part_i,
                                    const float* __restrict__ part_ms,
                                    float* __restrict__ vals,
                                    int* __restrict__ idx,
                                    float* __restrict__ lse, int n, int k,
                                    int splits) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps leave together
  float lv[L];
  int li[L];
  clear(lv, li);
  float m = NEG, s = 0.f;
  for (int sp = lane; sp < splits; sp += 32) {
    const size_t o = (size_t)sp * n + row;
#pragma unroll
    for (int t = 0; t < L; ++t)
      insert(lv, li, part_v[o * L + t], part_i[o * L + t]);
    merge_ms(m, s, part_ms[o * 2], part_ms[o * 2 + 1]);
  }
  merge_lanes(lv, li, m, s, 32);
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < L; ++t) {
      if (t < k) {
        vals[(size_t)row * k + t] = lv[t];
        idx[(size_t)row * k + t] = li[t];
      }
    }
    lse[row] = m + logf(s);
  }
}

template <int L>
int combine(const void* part_v, const void* part_i, const void* part_ms,
            void* vals, void* idx, void* lse, int n, int k, int splits,
            cudaStream_t st) {
  constexpr int kRowsPerBlock = 8;  // 8 warps
  topk_combine_kernel<L><<<(n + kRowsPerBlock - 1) / kRowsPerBlock,
                           32 * kRowsPerBlock, 0, st>>>(
      (const float*)part_v, (const int*)part_i, (const float*)part_ms,
      (float*)vals, (int*)idx, (float*)lse, n, k, splits);
  return (int)cudaGetLastError();
}

size_t smem_bytes_bf16(int d) {
  return 1024 + (size_t)wg::tile_bytes(wg::kRows, d) +
         (size_t)kStages * wg::tile_bytes(kTV16, d);
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// vocab tiles per split for `splits` splits of tiles of `tv` rows, or -1
// when the arguments are bad or a split would own no tile
int split_tiles(int n, int d, int v, int k, int splits, int tv) {
  if (n <= 0 || v <= 0 || d <= 0 || d > ce::kMaxD || d % 8 || splits <= 0 ||
      k < 1 || k > kMaxK || k > v)
    return -1;
  const int nvt = (v + tv - 1) / tv;
  const int tps = (nvt + splits - 1) / splits;
  return (splits - 1) * tps >= nvt ? -1 : tps;
}

// What the wrapper cuts the vocab into splits by, into out[3]: `rows` of
// h per tile, `vocab_rows` of W per tile, and how many blocks of the
// partial kernel `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) fit an SM, from the occupancy calculator. 0 on success, else a
// CUDA error.
int tiling(const void* kernel, int threads, size_t smem, int rows,
           int vocab_rows, int* out) {
  const int err = set_smem(kernel, smem);
  if (err) return err;
  out[0] = rows;
  out[1] = vocab_rows;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                            threads, smem);
}

template <int L>
int launch_f32(const void* h, const void* w, const void* b, void* vals,
               void* idx, void* lse, void* part_v, void* part_i,
               void* part_ms, int n, int d, int v, int k, int splits,
               int tps, cudaStream_t st) {
  topk_tiled_kernel<L><<<dim3((n + tiled::kBM - 1) / tiled::kBM, splits),
                         tiled::kThreads, 0, st>>>(
      (const float*)h, (const float*)w, (const float*)b, (float*)part_v,
      (int*)part_i, (float*)part_ms, n, d, v, tps);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return combine<L>(part_v, part_i, part_ms, vals, idx, lse, n, k, splits,
                    st);
}

template <int L>
int launch_bf16(const void* h, const void* w, const void* b, void* vals,
                void* idx, void* lse, void* part_v, void* part_i,
                void* part_ms, int n, int d, int v, int k, int splits,
                int tps, cudaStream_t st) {
  CUtensorMap hmap, wmap;
  int err = wg::make_map(&hmap, h, n, d, wg::kRows);
  if (err) return err;
  err = wg::make_map(&wmap, w, v, d, kTV16);
  if (err) return err;
  const size_t smem = smem_bytes_bf16(d);
  err = set_smem((const void*)topk_wgmma_kernel<L>, smem);
  if (err) return err;
  topk_wgmma_kernel<L><<<dim3((n + wg::kRows - 1) / wg::kRows, splits),
                         wg::kThreads, smem, st>>>(
      hmap, wmap, (const float*)b, (float*)part_v, (int*)part_i,
      (float*)part_ms, n, d, v, tps);
  err = (int)cudaGetLastError();
  if (err) return err;
  return combine<L>(part_v, part_i, part_ms, vals, idx, lse, n, k, splits,
                    st);
}

// the dtype's kernels with lists of the smallest of 1, 2, 4, 8 that
// holds k
template <int L>
int launch(bool bf16, const void* h, const void* w, const void* b,
           void* vals, void* idx, void* lse, void* part_v, void* part_i,
           void* part_ms, int n, int d, int v, int k, int splits, int tps,
           cudaStream_t st) {
  return (bf16 ? launch_bf16<L> : launch_f32<L>)(
      h, w, b, vals, idx, lse, part_v, part_i, part_ms, n, d, v, k, splits,
      tps, st);
}

int launch_k(bool bf16, const void* h, const void* w, const void* b,
             void* vals, void* idx, void* lse, void* part_v, void* part_i,
             void* part_ms, int n, int d, int v, int k, int splits,
             void* stream) {
  const int tps = split_tiles(n, d, v, k, splits,
                              bf16 ? kTV16 : tiled::kBN);
  if (tps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto go = k == 1 ? launch<1> : k == 2 ? launch<2>
          : k <= 4 ? launch<4> : launch<kMaxK>;
  return go(bf16, h, w, b, vals, idx, lse, part_v, part_i, part_ms, n, d, v,
            k, splits, tps, st);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the bf16 partial kernel
// needs (the f32 one has only static shared memory).
size_t deepsc_topk_smem_bytes_bf16(int d) { return smem_bytes_bf16(d); }

// The splits' terms at width d, out[3] as `tiling` fills it for the
// partial kernel of the dtype on the current device (the instance with
// lists of 8; a shorter list takes fewer registers, and the registers (f32)
// or the shared memory (bf16) bound the blocks per SM either way).
int deepsc_topk_tiling_f32(int d, int* out) {
  if (d <= 0 || d > ce::kMaxD || d % 8) return (int)cudaErrorInvalidValue;
  return tiling((const void*)topk_tiled_kernel<kMaxK>, tiled::kThreads, 0,
                tiled::kBM, tiled::kBN, out);
}

int deepsc_topk_tiling_bf16(int d, int* out) {
  if (d <= 0 || d > ce::kMaxD || d % 8) return (int)cudaErrorInvalidValue;
  return tiling((const void*)topk_wgmma_kernel<kMaxK>, wg::kThreads,
                smem_bytes_bf16(d), wg::kRows, kTV16, out);
}

// h: contiguous f32 (N, D), D a multiple of 8 up to 256; w: contiguous f32
// (V, D); b: f32 (V); vals: f32 (N, k); idx: int32 (N, k); lse: f32 (N);
// part_v: f32 workspace (splits, N, 8); part_i: int32 (splits, N, 8);
// part_ms: f32 (splits, N, 2). 1 <= k <= min(8, V); every split must own
// at least one vocab tile of 128 rows. Returns cudaGetLastError() after
// the launches (0 = success).
int deepsc_topk_f32(const void* h, const void* w, const void* b, void* vals,
                    void* idx, void* lse, void* part_v, void* part_i,
                    void* part_ms, int n, int d, int v, int k, int splits,
                    void* stream) {
  return launch_k(false, h, w, b, vals, idx, lse, part_v, part_i, part_ms, n,
                  d, v, k, splits, stream);
}

// As above with h and w in bf16.
int deepsc_topk_bf16(const void* h, const void* w, const void* b, void* vals,
                     void* idx, void* lse, void* part_v, void* part_i,
                     void* part_ms, int n, int d, int v, int k, int splits,
                     void* stream) {
  return launch_k(true, h, w, b, vals, idx, lse, part_v, part_i, part_ms, n,
                  d, v, k, splits, stream);
}

}  // extern "C"
