// The online softmax of the bf16 tensor-core cross-entropy forwards (the
// tuned K3 of csrc/ce_fwd.cu and the wide K3 of csrc/ce_wide_fwd.cu, and the
// wide K6 of csrc/topk_wide_mma.cu, which reads no label), the ring that
// streams D through the wide kernels' tiles, and the host pieces the
// libraries share: the merge of the vocab splits, the split sizes and the
// occupancy query the wrapper cuts the vocab by.
//
// A block holds a 64-row tile of h and walks vocab tiles of 128 rows of W;
// a tile's logits S = h_t . W_t^T are a wgmma m64n128 f32 accumulator
// (csrc/wgmma_tile.cuh), of which thread t (lane l) holds rows r and r + 8
// (r = 16 (t / 32) + l / 4) at columns 8 q + 2 (l % 4) + e (q < 16,
// e < 2): value 4 q + 2 i + e of the accumulator. Each thread keeps a
// running (max, sum of exponentials, gold logit) of its two rows over its
// columns (ex2 on log2(e)-scaled values); the four threads of a row are
// merged by shuffles once at the end, the splits of a row in order by a
// second kernel. No atomics: the same bits on every call.

#pragma once

#include "ce_tile.cuh"
#include "wgmma_tile.cuh"

namespace ceo {

constexpr int kTV = 128;  // vocab rows a tile: wgmma N

// the bias of the thread's columns c0 + 8 q + e of the vocab tile at col0
// (c0 = col0 + 2 (lane % 4)): 8-byte loads (c0 is even) but on a ragged
// last tile, whose columns from v on get 0
__device__ __forceinline__ void load_bias(float (&bias)[32],
                                          const float* __restrict__ b,
                                          int col0, int c0, int v) {
  if (col0 + kTV <= v) {
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
}

// One thread's online-softmax state: rows r and r + 8 of the row tile, over
// its columns 8 q + 2 (lane % 4) + e (q < 16, e < 2) of each vocab tile.
struct Softmax {
  int lab[2];
  float m[2], s[2], gold[2];

  // rows row and row + 8 of h (N rows) and their labels (none when
  // `labels` is null: the gold logit then stays 0)
  __device__ __forceinline__ void init(const int* __restrict__ labels,
                                       int row, int n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lab[i] = labels != nullptr && row + 8 * i < n ? labels[row + 8 * i]
                                                    : -1;
      m[i] = ce::NEG;
      s[i] = 0.f;
      gold[i] = 0.f;
    }
  }

  // folds in the logits acc (64 x 128 accumulator, bias added in place) of
  // the vocab tile at col0; c0 = col0 + 2 (lane % 4); columns from `lim` on
  // (a ragged last tile) are left out
  template <bool kRagged>
  __device__ __forceinline__ void add(float (&acc)[64], const float* bias,
                                      int col0, int c0, int lim) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float cm = ce::NEG;
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
          se += wg::exp2_approx(
              fmaf(acc[4 * q + 2 * i + e], wg::kLog2e, -mn2));
      s[i] = s[i] * wg::exp2_approx((m[i] - mn) * wg::kLog2e) + se;
      m[i] = mn;
      if (lab[i] >= col0 && lab[i] < col0 + kTV) {
#pragma unroll
        for (int q = 0; q < 16; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (c0 + 8 * q + e == lab[i]) gold[i] = acc[4 * q + 2 * i + e];
      }
    }
  }

  // adds the tile's logits acc, the last tile ragged when v ends in it
  __device__ __forceinline__ void add_tile(float (&acc)[64],
                                           const float* bias, int col0,
                                           int c0, int v) {
    if (col0 + kTV <= v)
      add<false>(acc, bias, col0, c0, v);
    else
      add<true>(acc, bias, col0, c0, v);
  }

  // merges the four threads of each row (lanes 4 g .. 4 g + 3), in the
  // same butterfly order in every run, and writes the rows' (max, sum,
  // gold) to part[split] (split, N, 3); row: the thread's first row
  __device__ __forceinline__ void store(float* __restrict__ part, int split,
                                        int row, int n, int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s[i], off);
        const float g2 = __shfl_xor_sync(0xffffffffu, gold[i], off);
        const float mn = fmaxf(m[i], m2);
        s[i] = s[i] * wg::exp2_approx((m[i] - mn) * wg::kLog2e) +
               s2 * wg::exp2_approx((m2 - mn) * wg::kLog2e);
        gold[i] += g2;
        m[i] = mn;
      }
      if ((lane & 3) == 0 && row + 8 * i < n) {
        float* out = part + ((size_t)split * n + row + 8 * i) * 3;
        out[0] = m[i];
        out[1] = s[i];
        out[2] = gold[i];
      }
    }
  }
};

// The streamed logits of the wide kernels (csrc/ce_wide_fwd.cu,
// csrc/topk_wide_mma.cu): block (row tile, vocab split) walks its `count`
// vocab tiles of kTV rows of W against its 64 rows of h with D as a k-loop
// of 64-column chunks. A ring stage holds one chunk of h's tile and of W's
// tile (8 + 16 KB, TMA loads into 128-byte-swizzled slabs, one mbarrier a
// stage). The chunks of a vocab tile accumulate into one 64 x 128 f32 tile
// (wgmma m64n128k16); each chunk's products are waited for while the next
// chunk's run, its stage then refilled with the chunk kStages ahead (across
// vocab tiles, so the next tile's loads run under this tile's epilogue).
// The TMA fills columns past D with zeros (a k-step past D adds exact
// zeros; the k-steps wholly past D are not issued).
template <int kStages>
struct Ring {
  static constexpr int kHBytes = wg::kRows * wg::kRowBytes;  // 8 KB
  static constexpr int kWBytes = kTV * wg::kRowBytes;        // 16 KB
  static constexpr int kStageBytes = kHBytes + kWBytes;
  // dynamic shared memory of the ring, its 1,024-byte alignment included
  static constexpr size_t kBytes = 1024 + (size_t)kStages * kStageBytes;

  const CUtensorMap* hmap;
  const CUtensorMap* wmap;
  uint8_t* ring;
  uint64_t* bar;  // kStages mbarriers in shared memory
  int row0, t0, nk, ksteps, total;

  // chunk j (k-chunk j % nk of vocab tile t0 + j / nk) -> stage j % kStages
  __device__ __forceinline__ void load(int j) {
    uint8_t* st = ring + (j % kStages) * kStageBytes;
    uint64_t* bj = &bar[j % kStages];
    const int col = (j % nk) * wg::kSlabCols;
    wg::mbar_expect_tx(bj, kStageBytes);
    wg::load_box(st, hmap, bj, col, row0);
    wg::load_box(st + kHBytes, wmap, bj, col, (t0 + j / nk) * kTV);
  }

  // every warp's products of chunk j are done: refill its stage
  __device__ __forceinline__ void release(int j) {
    __syncthreads();
    if (threadIdx.x == 0 && j + kStages < total) load(j + kStages);
  }

  // By every thread of the block: the barriers set up and the first
  // kStages chunks asked for, for `count` vocab tiles from t0 at padded
  // width dp.
  __device__ __forceinline__ void begin(const CUtensorMap* h_map,
                                        const CUtensorMap* w_map,
                                        uint8_t* smem, uint64_t* bars,
                                        int row, int tile0, int count,
                                        int dp) {
    hmap = h_map;
    wmap = w_map;
    ring = wg::align_1024(smem);
    bar = bars;
    row0 = row;
    t0 = tile0;
    nk = wg::slabs(dp);
    ksteps = (dp + 15) / 16;
    total = count * nk;
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) wg::mbar_init(&bar[i], 1);
      wg::mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < kStages && j < total; ++j) load(j);
    }
  }

  // acc = the logits of the block's 64 rows against its vocab tile `it`
  // (0 <= it < count), by every thread of the block
  __device__ __forceinline__ void tile(float (&acc)[64], int it) {
    const uint32_t ring_addr = wg::smem_u32(ring);
    wg::fence_regs(acc);
    for (int kc = 0; kc < nk; ++kc) {
      const int j = it * nk + kc;
      wg::mbar_wait(&bar[j % kStages], (j / kStages) & 1);
      const uint32_t a = ring_addr + (j % kStages) * kStageBytes;  // h
      const uint32_t w = a + kHBytes;                               // W
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (4 * kc + kk < ksteps)
          wg::mma_ss_n128(acc, wg::desc_k(a, wg::kRows, kk),
                          wg::desc_k(w, kTV, kk), kc > 0 || kk > 0);
      wg::commit();
      if (kc > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        release(j - 1);
      }
    }
    wg::wait_all();
    wg::fence_regs(acc);
    release(it * nk + nk - 1);
  }
};

// one thread per row: merge the splits in order; lse = m + log(s),
// ce = lse - gold
__global__ void ce_fwd_combine_kernel(const float* __restrict__ part,
                                      float* __restrict__ ce_out,
                                      float* __restrict__ lse_out, int n,
                                      int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float mm = ce::NEG;
  for (int sp = 0; sp < splits; ++sp)
    mm = fmaxf(mm, part[((size_t)sp * n + row) * 3]);
  float ss = 0.f, gg = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = part + ((size_t)sp * n + row) * 3;
    ss += p[1] * expf(p[0] - mm);
    gg += p[2];
  }
  const float lse = mm + logf(ss);
  lse_out[row] = lse;
  ce_out[row] = lse - gg;
}

inline int combine(const void* part, void* ce_out, void* lse_out, int n,
                   int splits, cudaStream_t st) {
  ce_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)part, (float*)ce_out, (float*)lse_out, n, splits);
  return (int)cudaGetLastError();
}

// vocab tiles per split for `splits` splits of tiles of `tv` rows, or -1
// when the sizes are bad or a split would own no tile
inline int split_tiles(int n, int v, int splits, int tv) {
  if (n <= 0 || v <= 0 || splits <= 0) return -1;
  const int nvt = (v + tv - 1) / tv;
  const int tps = (nvt + splits - 1) / splits;
  return (splits - 1) * tps >= nvt ? -1 : tps;
}

inline int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// What the wrapper cuts the vocab into splits by, into out[3]: `rows` of
// h per tile, `vocab_rows` of W per tile, and how many blocks of the
// partial kernel `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) fit an SM, from the occupancy calculator. 0 on success, else a
// CUDA error.
inline int tiling(const void* kernel, int threads, size_t smem, int rows,
                  int vocab_rows, int* out) {
  const int err = set_smem(kernel, smem);
  if (err) return err;
  out[0] = rows;
  out[1] = vocab_rows;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                            threads, smem);
}

}  // namespace ceo
