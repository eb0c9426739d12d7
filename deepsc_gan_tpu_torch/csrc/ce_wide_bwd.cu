// Online-softmax vocab cross-entropy backward at any width D, bf16, on
// Hopper's tensor cores (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_dh_kernel` and `_dw_kernel` of
// deepsc_gan_tpu/ops/pallas/ce.py where the tuned K4 (csrc/ce_bwd.cu: D a
// multiple of 16 up to 256) does not take the width: `--decoder-d-model
// 640` (the wide-heads decoder) or 200 runs here in bf16, up to 5,120
// columns. The f32 widths, and bf16 past 5,120, take csrc/ce_bwd_tiled.cu's
// CUDA-core kernels (exact f32 products, which the f32 step-parity checks
// need). Same function and roundings as the
// tuned K4: with h (N, D) and W (V, D) bf16, bias b (V) f32, labels y, the
// forward's lse (N) and the cotangent g (N),
//     P_nv = exp(h_n . W_v + b_v - lse_n) g_n - [v == y_n] g_n      (f32)
//     dh = Pc W (N, D),  dW = Pc^T h (V, D),  db = sum_n P_nv (V)
// with Pc = P rounded to bf16, f32 sums, and the logits never in device
// memory. With dW and db not asked for, dh alone (the dh-only mode).
//
// What bounds it: operations. At N = 1,984, D = 640, V = 22,234 the
// logits (once) and the two products are 3 x N D V = 84.7 G multiply-adds
// (169 GFLOP: 0.171 ms at the bf16 tensor-core rate), against 30 MB read
// and 62 MB written (0.028 ms at 3.35 TB/s). The kernels form the logits
// twice (once for dh, once for dW), 4 N D V in all.
//
// What the width costs, and the design:
// - Registers. A (64 x D) f32 accumulator fits one warpgroup up to D = 256
//   (128 registers a thread); at D = 640 it is 160 KB. So the output's D is
//   cut into slabs of 64 columns: a block has two consumer warpgroups of at
//   most five slabs each (640 columns, 160 registers a thread), and past
//   640 columns a cluster of G blocks (G = ceil(D / 640), at most 8: D up
//   to 5,120) shares the rows, each block owning G-th of the slabs.
// - The logits need all of D. Each warpgroup forms a partial S over its
//   own slabs only (wgmma m64n32k16, K-major from shared memory: A the
//   resident tile of 64 rows, B a streamed tile of 32), so S is formed
//   once: warpgroup 1 adds warpgroup 0's partial through shared memory
//   (64 x 32 f32), and in a cluster the G blocks' sums are added in rank
//   order, each warpgroup of a block reading half of them through
//   distributed shared memory after a cluster barrier. Every warpgroup so
//   holds the same S bit for bit, forms P from it in f32 registers, rounds
//   it to bf16 as the register A operand of the second product, and adds
//   Pc . B_t over its own slabs (wgmma m64n64k16, B read MN-major, no
//   transposed copy): the tuned K4's tile step, with the products split by
//   columns. The partial logits are f32 sums of each slab's tensor-core
//   sum, which land nearer the exact logits than one chain over all of a
//   warpgroup's k-steps; the products of tile t go out with the first
//   slab of tile t + 1's logits, each slab's group waited for while the
//   next one runs.
// - Streamed tiles of 32 rows, not 64. A whole tile of D = 640 is 80 KB a
//   64-row tile; beside the resident 80 KB, three 32-row stages fit 227 KB
//   and two 64-row ones do not. So D = 640 runs in one block, with no
//   cluster: in an earlier version of these kernels, with 64-row tiles and
//   D = 640 over a cluster of two, the exchange between the blocks (the
//   cluster barrier, the fence that makes the sums visible, the
//   distributed shared memory) cost about as much as the tile's products;
//   the exchange within a block costs little.
// - Each warpgroup's slab count is a compile-time constant (the kernels
//   are instantiated for the block's split: 5 + 5 slabs at D = 640), so no
//   wgmma sits behind a condition on data the compiler takes as divergent
//   (that serializes them, ptxas warning C7520), and none of an
//   accumulator's registers is written by anything but a wgmma (C7515).
// - Shared memory: the resident tile (64 rows x the block's columns, at
//   most 80 KB), a ring of 2-4 streamed tiles of 32 rows (TMA loads into
//   128-byte-swizzled slabs, each warp issuing one, an mbarrier a stage)
//   with each tile's row values (bias, or labels, lse and cotangents,
//   cp.async), and two 64 x 32 f32 slots for the sums.
// - D off the k-step. The TMA fills columns past D with zeros, and a
//   block's slabs past D (the last block of a cluster may hold fewer) are
//   zeroed once, so a k-step past D adds exact zeros. The TMA needs a row
//   of a multiple of 16 bytes: the wrapper passes, for D not a multiple of
//   8, zero-padded copies of width dp.
// Two kernels, as the tuned K4: dh by block (rank, row tile, vocab split)
// walking its vocab tiles, the splits' partials added in order by a third
// kernel; dW and db by block (rank, vocab tile of 64) walking every row
// tile of 32 in order (roles swapped: S^T = W_t . h_t^T, so P^T is already
// in the A layout), db the unrounded P's sum, written by the first block of
// the cluster. No atomics: every sum runs in a fixed order, the same bits
// on every call, and the dh-only mode's dh is the full mode's.

#include "wgmma_tile.cuh"

namespace {

constexpr int kWarpgroups = 2;                   // consumer warpgroups
constexpr int kThreads = kWarpgroups * wg::kThreads;
constexpr int kMaxNC = 5;                        // slabs a warpgroup holds
constexpr int kMaxBlockSlabs = kWarpgroups * kMaxNC;
constexpr int kMaxCluster = 8;                   // portable cluster size
constexpr int kMaxStages = 4;
constexpr int kTile = 32;                        // rows of a streamed tile
constexpr int kResBytes = wg::kRows * wg::kRowBytes;  // a resident slab
constexpr int kTileBytes = kTile * wg::kRowBytes;     // a streamed slab
constexpr int kSlotFloats = wg::kRows * kTile;        // a 64 x 32 partial
constexpr int kInfoFloats = 3 * kTile;                // a tile's row values
constexpr int kSmemBudget = 232448 - 256;  // the opt-in limit, less static
constexpr int kFenceThread = 64;  // issues no asynchronous copy

// ---- cluster ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the shared-memory address `addr` of this block, in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

// the warpgroup's index, through a shuffle so that the compiler knows it
// is the same in every thread of a warp (a wgmma on a path it takes as
// divergent is serialized, ptxas warning C7520)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / wg::kThreads, 0);
}

// the two warpgroups of the block
__device__ __forceinline__ void block_bar() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// ---- products of a streamed tile of 32 rows ----

// d (+)= A . B, m64n32k16: A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// p = A . B^T over the NC slabs (A: 64 rows at `a`, B: 32 rows at `b`,
// K-major slabs in shared memory): each slab's 4 k-steps in the tensor
// cores into a temporary (two, in turn), and the slabs' sums added in f32
// as their groups complete, each waited for while the next slab's runs.
// Products issued before (after the caller's wgmma fence) go in the first
// slab's group; all are done on return. One chain over every k-step sums
// in the tensor cores' own rounding: its logits were as far from the
// exact ones as to make a P near 1 round to bf16 the other way on
// chip_smoke.py's inputs at D = 512 (dW 2.25e-3 of the softmax part off,
// the plain version 2.1e-4: scripts/ce_wide_bwd_variants.py).
template <int NC>
__device__ __forceinline__ void form_logits(float (&p)[16], uint32_t a,
                                            uint32_t b) {
  float t[2][16];
#pragma unroll
  for (int sl = 0; sl < NC; ++sl) {
    float(&u)[16] = t[sl & 1];
    if (sl >= 2) {  // u was read two slabs ago
      wg::fence_regs(u);
      wg::fence();
    }
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4)
      mma_ss_n32(u, wg::desc_k(a, wg::kRows, 4 * sl + k4),
                 wg::desc_k(b, kTile, 4 * sl + k4), k4 > 0);
    wg::commit();
    if (sl >= 1) {
      wait_one();
      float(&v)[16] = t[(sl - 1) & 1];
      wg::fence_regs(v);
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = sl == 1 ? v[i] : p[i] + v[i];
    }
  }
  wg::wait_all();
  float(&v)[16] = t[(NC - 1) & 1];
  wg::fence_regs(v);
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = NC == 1 ? v[i] : p[i] + v[i];
}

// acc[s] (+)= P . B[:, slab s] for NC slabs at b (a tile of 32 rows read
// MN-major: two k-steps); P (64 x 32) in registers; `first` overwrites.
// Issued, not waited for.
template <int NC>
__device__ __forceinline__ void issue_products(float (&acc)[NC][32],
                                               uint32_t (&a)[8], uint32_t b,
                                               int first) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int s = 0; s < NC; ++s)
      wg::mma_rs_n64(acc[s], a + 4 * kk, wg::desc_mn(b, kTile, s, kk),
                     kk > 0 || !first);
}

// the (64 x 32) f32 accumulator rounded to bf16: the A operand of two
// 16-row k-steps, a[4 kk .. 4 kk + 3] for step kk
__device__ __forceinline__ void to_a(const float (&p)[16], uint32_t (&a)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
    a[i] = *reinterpret_cast<const uint32_t*>(&x);
  }
}

// ---- the block's slabs and shared memory ----

struct Geo {
  int block_slabs;  // slabs a block owns (the last block may own fewer)
  int stages;       // the ring's stages
};

// what a block owns: its first global slab, the slabs of D it holds
// (fewer than block_slabs in the last block of a cluster when the slabs do
// not divide evenly; its other slabs are zero in shared memory)
struct Share {
  int s0, bsr;
  __device__ Share(const Geo& geo, int dp, int rank) {
    s0 = rank * geo.block_slabs;
    bsr = min(geo.block_slabs, wg::slabs(dp) - s0);
  }
};

struct Smem {
  uint8_t* res;   // the resident tile: block_slabs slabs of 64 rows
  uint8_t* ring;  // stages x block_slabs slabs of 32 rows
  float* slot;    // two 64 x 32 f32 sums
  float* info;    // stages x kInfoFloats: the streamed tiles' row values
  int stage_bytes;
  __device__ Smem(uint8_t* raw, const Geo& geo)
      : res(wg::align_1024(raw)),
        ring(res + geo.block_slabs * kResBytes),
        slot(reinterpret_cast<float*>(
            ring + geo.stages * geo.block_slabs * kTileBytes)),
        info(slot + 2 * kSlotFloats),
        stage_bytes(geo.block_slabs * kTileBytes) {}
  __device__ uint8_t* stage(int it, int stages) const {
    return ring + (it % stages) * stage_bytes;
  }
  __device__ float* info_of(int it, int stages) const {
    return info + (it % stages) * kInfoFloats;
  }
};

// slabs [s0, s0 + count) of rows [row0, row0 + rows) of a tensor map whose
// box is (64 columns, rows) -> consecutive slabs of `rows` rows at dst;
// completes on `bar`. Called by every thread: thread 0 tells the barrier
// to expect all the bytes, and lane 0 of warp w issues slabs w and w + 8
// (a tensor copy takes about a hundred cycles to issue, which one thread
// issuing them all would add to its warpgroup's tile).
__device__ __forceinline__ void load_slabs(uint8_t* dst,
                                           const CUtensorMap* map,
                                           uint64_t* bar, int s0, int count,
                                           int row0, int rows) {
  if (threadIdx.x == 0)
    wg::mbar_expect_tx(bar, (uint32_t)(count * rows * wg::kRowBytes));
  if ((threadIdx.x & 31) == 0) {
    for (int s = threadIdx.x >> 5; s < count; s += kThreads / 32)
      wg::load_box(dst + s * rows * wg::kRowBytes, map, bar,
                   (s0 + s) * wg::kSlabCols, row0);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   wg::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// What the P of a streamed tile needs beside the logits, copied (cp.async,
// zero past the end) into `info` by the block's first 32 threads: for dh
// (vocab tile t) the bias of its columns; for dW (row tile t) the labels,
// lse and cotangents of its rows (a row past N gets label 0 and
// cotangent 0, so its P is 0).
template <bool kDW>
__device__ __forceinline__ void load_info(float* info, int t,
                                          const float* __restrict__ b,
                                          const int* __restrict__ labels,
                                          const float* __restrict__ lse_in,
                                          const float* __restrict__ g_in,
                                          int n, int v) {
  const int i = threadIdx.x;
  if (i >= kTile) return;
  const int at = t * kTile + i;
  if constexpr (kDW) {
    const bool ok = at < n;
    const int src = ok ? at : 0;
    cp_async4(info + i, labels + src, ok);
    cp_async4(info + kTile + i, lse_in + src, ok);
    cp_async4(info + 2 * kTile + i, g_in + src, ok);
  } else {
    const bool ok = at < v;
    cp_async4(info + i, b + (ok ? at : 0), ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// S = the sum of every warpgroup's partial p in the cluster, the same bits
// in every thread that holds a given element: warpgroup 0 writes its
// partial to the block's slot, warpgroup 1 adds its own to it (the block's
// sum), and the G blocks' sums are added in rank order. Slot layout: value
// i of thread tw at float4 (i / 4) * 128 + tw, so a warp's 16-byte
// accesses are consecutive. In a one-block cluster every thread reads its
// block's sum after the block's barrier (two slots, used by the tiles in
// turn). Else, after a cluster barrier (one release fence a block, relaxed
// arrivals), each warpgroup adds half of the elements over the G blocks,
// its own block's from shared memory and the others' through distributed
// shared memory, writes them to the other slot (which no block reads any
// more), and every thread reads the whole sum there after the block's
// barrier.
__device__ __forceinline__ void cluster_sum(const float (&p)[16],
                                            float (&s)[16], float* slot,
                                            int it, int wgi, int tw,
                                            int ranks, int rank) {
  const int buf = it & 1;
  float4* mine = reinterpret_cast<float4*>(slot + buf * kSlotFloats);
  if (wgi == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mine[j * wg::kThreads + tw] =
          make_float4(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]);
  }
  block_bar();
  if (wgi == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 x = mine[j * wg::kThreads + tw];
      mine[j * wg::kThreads + tw] =
          make_float4(x.x + p[4 * j], x.y + p[4 * j + 1],
                      x.z + p[4 * j + 2], x.w + p[4 * j + 3]);
    }
  }
  block_bar();
  const float4* sums = mine;
  if (ranks > 1) {
    // a thread with no copies of its own in flight (the first 32 load the
    // row values), which the fence would wait for
    if (threadIdx.x == kFenceThread)
      asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    asm volatile(
        "barrier.cluster.arrive.relaxed.aligned;\n"
        "barrier.cluster.wait.acquire.aligned;\n" ::
            : "memory");
    float4* out = reinterpret_cast<float4*>(slot + (buf ^ 1) * kSlotFloats);
    const uint32_t base = wg::smem_u32(mine) + 16u * tw;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * wgi + h;
      const uint32_t off = 16u * wg::kThreads * j;
      float4 x = rank == 0 ? mine[j * wg::kThreads + tw]
                           : ld_cluster(map_rank(base, 0) + off);
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) {
        if (r >= ranks) break;
        const float4 y = r == rank ? mine[j * wg::kThreads + tw]
                                   : ld_cluster(map_rank(base, r) + off);
        x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
      }
      out[j * wg::kThreads + tw] = x;
    }
    block_bar();
    sums = out;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 x = sums[j * wg::kThreads + tw];
    s[4 * j] = x.x;
    s[4 * j + 1] = x.y;
    s[4 * j + 2] = x.z;
    s[4 * j + 3] = x.w;
  }
}

// Stores a warpgroup's (64 x 64 ncw) part of an f32 accumulator: rows
// row0 + r + 8 i below `rows`, columns col0 + 64 s + 8 q + 2 (lane % 4)
// (+ 0, 1) below d, into the row-major (rows, d) array out.
template <int NC>
__device__ __forceinline__ void store_acc(const float (&acc)[NC][32],
                                          float* out, int row0, int r,
                                          int rows, int col0, int ncw,
                                          int d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    if (row >= rows) continue;
    float* o = out + (size_t)row * d;
#pragma unroll
    for (int s = 0; s < NC; ++s) {
      if (s >= ncw) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = col0 + 64 * s + 8 * q + 2 * (lane & 3);
        const float x0 = acc[s][4 * q + 2 * i];
        const float x1 = acc[s][4 * q + 2 * i + 1];
        if (col + 1 < d && (d % 2) == 0) {
          *reinterpret_cast<float2*>(o + col) = make_float2(x0, x1);
        } else {
          if (col < d) o[col] = x0;
          if (col + 1 < d) o[col + 1] = x1;
        }
      }
    }
  }
}

// The arguments of either kernel.
struct Args {
  const float* b;
  const int* labels;
  const float* lse;
  const float* g;
  float* out;  // dh_part (dh kernel) or dW (dW kernel)
  float* db;
  int n, d, dp, v, tiles_per_split;
  Geo geo;
};

// A warpgroup's values of its two rows of the resident tile (r and r + 8):
// dh: their labels, lse and cotangents; dW: their vocab ids and bias.
struct RowVals {
  int lab[2];
  float lse[2], g[2], bias[2];
};

// exp(s + b - lse) g as the tuned K4 forms it: ex2 of the log2(e)-scaled
// logit less lse (the plain version's roundings and expf measured the same
// errors against it, 8 % slower: scripts/ce_wide_bwd_variants.py)
__device__ __forceinline__ float prob(float s, float b, float lse, float g) {
  return wg::exp2_approx(fmaf(s + b, wg::kLog2e, -lse * wg::kLog2e)) * g;
}

// P of a streamed tile over the summed logits s, in place (a plain array,
// not a product's accumulator: writing over it serializes nothing);
// `info` holds the tile's row values, col0 its first vocab column (dh).
// dW adds the unrounded P^T of each of the thread's vocab rows to dbs.
template <bool kDW>
__device__ __forceinline__ void tile_p(float (&s)[16], const float* info,
                                       const RowVals& rv, float (&dbs)[2],
                                       int col0, int v) {
  const int c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (kDW) {
      const float2 lb = *reinterpret_cast<const float2*>(info + 8 * q + c2);
      const float2 ls =
          *reinterpret_cast<const float2*>(info + kTile + 8 * q + c2);
      const float2 gg =
          *reinterpret_cast<const float2*>(info + 2 * kTile + 8 * q + c2);
      const int rl[2] = {__float_as_int(lb.x), __float_as_int(lb.y)};
      const float rs[2] = {ls.x, ls.y};
      const float rg[2] = {gg.x, gg.y};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float y = prob(s[4 * q + 2 * i + e], rv.bias[i], rs[e], rg[e]);
          if (rv.lab[i] == rl[e]) y -= rg[e];
          dbs[i] += y;
          s[4 * q + 2 * i + e] = y;
        }
    } else {
      const float2 bb = *reinterpret_cast<const float2*>(info + 8 * q + c2);
      const float bc[2] = {bb.x, bb.y};
      const int c0 = col0 + 8 * q + c2;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float y = prob(s[4 * q + 2 * i + e], bc[e], rv.lse[i], rv.g[i]);
          if (c0 + e == rv.lab[i]) y -= rv.g[i];
          s[4 * q + 2 * i + e] = c0 + e < v ? y : 0.f;
        }
    }
  }
}

// The walk's shared state: the arguments, shared memory, barriers, the
// block's share and the streamed tiles (t0, count) of its resident tile.
struct Walk {
  const Args& x;
  const Smem& sm;
  uint64_t* bar;  // the ring's stages, then the resident tile's
  const Share& sh;
  const CUtensorMap* bmap;
  int wgi, rank, row0, t0, count;
  __device__ uint32_t stage(int it, int ls0) const {
    return wg::smem_u32(sm.stage(it, x.geo.stages)) + ls0 * kTileBytes;
  }
  __device__ void wait(int it) const {
    wg::mbar_wait(&bar[it % x.geo.stages], (it / x.geo.stages) & 1);
  }
  // every warp is past tile it's products, and this thread's row-value
  // copies of earlier tiles have landed: refill the tile's stage and row
  // values with tile it + stages
  template <bool kDW>
  __device__ void refill(int it) const {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int t = it + x.geo.stages;
    if (t < count) {
      load_slabs(sm.stage(it, x.geo.stages), bmap, &bar[it % x.geo.stages],
                 sh.s0, sh.bsr, (t0 + t) * kTile, kTile);
      load_info<kDW>(sm.info_of(it, x.geo.stages), t0 + t, x.b, x.labels,
                     x.lse, x.g, x.n, x.v);
    }
  }
};

// One tile of a warpgroup of NC > 0 slabs, whose partial logits p are
// formed: sum them over the cluster, form P, then add Pc . B_t into acc
// and form the next tile's partial logits in p (the last tile forms a
// spare one from its own stage), the products going out with the first
// slab's logits.
template <bool kDW, int NC>
__device__ __forceinline__ void tile(const Walk& w, int it, int ls0,
                                     const RowVals& rv, float (&dbs)[2],
                                     float (&acc)[NC][32], float (&p)[16]) {
  const int tw = threadIdx.x % wg::kThreads;
  const int nx = it + 1 < w.count ? it + 1 : it;
  if (nx != it) w.wait(nx);
  float s[16];
  cluster_sum(p, s, w.sm.slot, it, w.wgi, tw, (int)gridDim.x, w.rank);
  tile_p<kDW>(s, w.sm.info_of(it, w.x.geo.stages), rv, dbs,
              (w.t0 + it) * kTile, w.x.v);
  uint32_t a[8];
  to_a(s, a);
  wg::fence_regs(a);
#pragma unroll
  for (int j = 0; j < NC; ++j) wg::fence_regs(acc[j]);
  wg::fence();
  issue_products<NC>(acc, a, w.stage(it, ls0), it == 0);
  form_logits<NC>(p, wg::smem_u32(w.sm.res) + ls0 * kResBytes,
                  w.stage(nx, ls0));
#pragma unroll
  for (int j = 0; j < NC; ++j) wg::fence_regs(acc[j]);
  wg::fence_regs(a);
  w.refill<kDW>(it);
}

// One warpgroup's walk over the streamed tiles: it holds NC slabs from the
// block's local slab ls0. dh (kDW false): the resident tile is the block's
// 64 rows of h, the streamed ones its vocab split's tiles of 32 rows of W;
// dW: the resident tile is a vocab tile of 64 rows of W, the streamed ones
// every tile of 32 rows of h. A warpgroup of no slab (a block of one slab)
// only adds zeros to the sums and keeps the barriers.
template <bool kDW, int NC>
__device__ __forceinline__ void walk(const Walk& w, int ls0) {
  const Args& x = w.x;
  const int tw = threadIdx.x % wg::kThreads;
  const int lane = threadIdx.x & 31;
  // rows r and r + 8 of the resident tile; columns (dh) or rows (dW)
  // 8 q + 2 (lane % 4) + e of a streamed tile (q < 4, e < 2)
  const int r = (tw >> 5) * 16 + (lane >> 2);
  RowVals rv;
  float dbs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w.row0 + r + 8 * i;
    if constexpr (kDW) {
      rv.lab[i] = row;  // the vocab row
      rv.bias[i] = row < x.v ? x.b[row] : 0.f;
    } else {
      const bool ok = row < x.n;
      rv.lab[i] = ok ? x.labels[row] : -1;
      rv.lse[i] = ok ? x.lse[row] : 0.f;
      rv.g[i] = ok ? x.g[row] : 0.f;
    }
  }
  float p[16];  // the tile's partial logits
  if constexpr (NC == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = 0.f;
    for (int it = 0; it < w.count; ++it) {
      float s[16];
      cluster_sum(p, s, w.sm.slot, it, w.wgi, tw, (int)gridDim.x, w.rank);
      w.refill<kDW>(it);
    }
  } else {
    float acc[NC][32];  // overwritten by the first tile's products
    w.wait(0);
    wg::fence();
    form_logits<NC>(p, wg::smem_u32(w.sm.res) + ls0 * kResBytes,
                    w.stage(0, ls0));
    for (int it = 0; it < w.count; ++it)
      tile<kDW, NC>(w, it, ls0, rv, dbs, acc, p);
    store_acc(acc, x.out, w.row0, r, kDW ? x.v : x.n,
              (w.sh.s0 + ls0) * wg::kSlabCols,
              max(0, min(NC, w.sh.bsr - ls0)), x.d);
  }
  if constexpr (kDW) {
    if (w.rank == 0 && w.wgi == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dbs[i] += __shfl_xor_sync(0xffffffffu, dbs[i], 1);
        dbs[i] += __shfl_xor_sync(0xffffffffu, dbs[i], 2);
        if ((lane & 3) == 0 && rv.lab[i] < x.v) x.db[rv.lab[i]] = dbs[i];
      }
    }
  }
}

// Either kernel's body: block (rank, resident tile, split). Zeroes the
// slabs past D that the block holds but the TMA never loads, starts the
// loads (the resident tile and the first `stages` streamed tiles, with
// their row values), walks the streamed tiles in its two warpgroups, and
// leaves only when no block of the cluster reads its slots any more.
template <bool kDW, int NC0, int NC1>
__device__ __forceinline__ void body(const CUtensorMap* amap,
                                     const CUtensorMap* bmap, const Args& x,
                                     uint8_t* smem_raw, uint64_t* bar) {
  const Geo& geo = x.geo;
  const Smem sm(smem_raw, geo);
  const int rank = (int)cluster_rank();
  const int wgi = warpgroup();
  const Share sh(geo, x.dp, rank);
  const int row0 = blockIdx.y * wg::kRows;  // of the resident tile
  int t0, count;
  if constexpr (kDW) {
    t0 = 0;
    count = (x.n + kTile - 1) / kTile;
  } else {
    const int nvt = (x.v + kTile - 1) / kTile;
    t0 = blockIdx.z * x.tiles_per_split;
    count = min(t0 + x.tiles_per_split, nvt) - t0;
  }
  // slabs [bsr, block_slabs) of the resident tile and of every stage
  const int missing = geo.block_slabs - sh.bsr;
  if (missing > 0) {
    const int res16 = missing * kResBytes / 16;
    const int tile16 = missing * kTileBytes / 16;
    for (int e = threadIdx.x; e < res16 + geo.stages * tile16;
         e += kThreads) {
      uint4* at;
      if (e < res16) {
        at = reinterpret_cast<uint4*>(sm.res + sh.bsr * kResBytes) + e;
      } else {
        const int k = (e - res16) / tile16;
        at = reinterpret_cast<uint4*>(sm.stage(k, geo.stages) +
                                      sh.bsr * kTileBytes) +
             (e - res16 - k * tile16);
      }
      *at = make_uint4(0, 0, 0, 0);
    }
    // the products read shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i <= geo.stages; ++i) wg::mbar_init(&bar[i], 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  load_slabs(sm.res, amap, &bar[geo.stages], sh.s0, sh.bsr, row0,
             wg::kRows);
  for (int i = 0; i < geo.stages && i < count; ++i) {
    load_slabs(sm.stage(i, geo.stages), bmap, &bar[i], sh.s0, sh.bsr,
               (t0 + i) * kTile, kTile);
    load_info<kDW>(sm.info_of(i, geo.stages), t0 + i, x.b, x.labels, x.lse,
                   x.g, x.n, x.v);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  wg::mbar_wait(&bar[geo.stages], 0);
  const Walk w{x, sm, bar, sh, bmap, wgi, rank, row0, t0, count};
  if (wgi == 0)
    walk<kDW, NC0>(w, 0);
  else
    walk<kDW, NC1>(w, NC0);
  cluster_sync();  // no block leaves while another reads its slots
}

// dh partial of block (rank, row tile, split): the sum over its vocab tiles
// of Pc W_t[:, own columns], into dh_part[split]
template <int NC0, int NC1>
__global__ void __launch_bounds__(kThreads, 1)
ce_dh_tc_kernel(const __grid_constant__ CUtensorMap hmap,
                const __grid_constant__ CUtensorMap wmap, Args x) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[kMaxStages + 1];
  x.out += (size_t)blockIdx.z * x.n * x.d;
  body<false, NC0, NC1>(&hmap, &wmap, x, smem_raw, bar);
}

// dW and db of block (rank, vocab tile): sums over every row tile of h, in
// order, of Pc^T h_t[:, own columns] and of P^T
template <int NC0, int NC1>
__global__ void __launch_bounds__(kThreads, 1)
ce_dw_tc_kernel(const __grid_constant__ CUtensorMap hmap,
                const __grid_constant__ CUtensorMap wmap, Args x) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[kMaxStages + 1];
  body<true, NC0, NC1>(&wmap, &hmap, x, smem_raw, bar);
}

// dh = sum over splits 0..S-1 of the partials, in order
__global__ void ce_dh_tc_sum_kernel(const float* __restrict__ dh_part,
                                    float* __restrict__ dh, int n, int d,
                                    int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)n * d;
  if (e >= total) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += dh_part[sp * total + e];
  dh[e] = acc;
}

// ---- host ----

struct Plan {
  int slabs, cluster, block_slabs, nc, stages;
  size_t smem;
};

// the cut of a (padded) width dp: its slabs, the cluster's blocks, the
// slabs a block owns, the slabs its warpgroup 0 holds (1 holds the rest),
// the ring's stages (each a streamed tile and its row values) and the
// dynamic shared memory a block needs
Plan plan(int dp) {
  Plan p;
  p.slabs = wg::slabs(dp);
  p.cluster = (p.slabs + kMaxBlockSlabs - 1) / kMaxBlockSlabs;
  p.block_slabs = (p.slabs + p.cluster - 1) / p.cluster;
  p.nc = (p.block_slabs + 1) / 2;
  const size_t stage =
      (size_t)p.block_slabs * kTileBytes + kInfoFloats * sizeof(float);
  const size_t fixed = 1024 + (size_t)p.block_slabs * kResBytes +
                       2 * kSlotFloats * sizeof(float);
  p.stages = (int)((kSmemBudget - fixed) / stage);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.smem = fixed + p.stages * stage;
  return p;
}

bool takes(int dp) {
  return dp > 0 && dp % 8 == 0 && plan(dp).cluster <= kMaxCluster;
}

int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// a launch of `kernel` over `grid` in clusters of grid.x blocks
int launch_cluster(void (*kernel)(CUtensorMap, CUtensorMap, Args),
                   dim3 grid, size_t smem, cudaStream_t st,
                   const CUtensorMap& hmap, const CUtensorMap& wmap,
                   const Args& x) {
  int err = set_smem((const void*)kernel, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, hmap, wmap, x);
  if (err) return err;
  return (int)cudaGetLastError();
}

// the tensor maps of h and W with boxes of 64 rows (resident) and of 32
// (streamed)
struct Maps {
  CUtensorMap h64, h32, w64, w32;
};

template <int NC0, int NC1>
int launch(const Maps& m, Args x, float* dh, float* dw, float* dh_part,
           int splits, const Plan& p, cudaStream_t st) {
  // dh: h resident, W streamed
  x.out = dh_part;
  int err = launch_cluster(
      ce_dh_tc_kernel<NC0, NC1>,
      dim3(p.cluster, (x.n + wg::kRows - 1) / wg::kRows, splits), p.smem,
      st, m.h64, m.w32, x);
  if (err) return err;
  const size_t total = (size_t)x.n * x.d;
  ce_dh_tc_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      dh_part, dh, x.n, x.d, splits);
  err = (int)cudaGetLastError();
  if (err || dw == nullptr) return err;
  // dW: W resident, h streamed
  x.out = dw;
  return launch_cluster(
      ce_dw_tc_kernel<NC0, NC1>,
      dim3(p.cluster, (x.v + wg::kRows - 1) / wg::kRows, 1), p.smem, st,
      m.h32, m.w64, x);
}

// the dh kernel (the instance for the plan's block slabs), for the
// occupancy calculator
const void* dh_kernel(int block_slabs) {
  switch (block_slabs) {
    case 1: return (const void*)ce_dh_tc_kernel<1, 0>;
    case 2: return (const void*)ce_dh_tc_kernel<1, 1>;
    case 3: return (const void*)ce_dh_tc_kernel<2, 1>;
    case 4: return (const void*)ce_dh_tc_kernel<2, 2>;
    case 5: return (const void*)ce_dh_tc_kernel<3, 2>;
    case 6: return (const void*)ce_dh_tc_kernel<3, 3>;
    case 7: return (const void*)ce_dh_tc_kernel<4, 3>;
    case 8: return (const void*)ce_dh_tc_kernel<4, 4>;
    case 9: return (const void*)ce_dh_tc_kernel<5, 4>;
    default: return (const void*)ce_dh_tc_kernel<5, 5>;
  }
}

}  // namespace

extern "C" {

// The plan at a padded width dp into out[6]: slabs of 64 columns, blocks a
// cluster, slabs a block, slabs warpgroup 0 holds, ring stages, dynamic
// shared memory bytes a block. Returns 0, or cudaErrorInvalidValue where
// the kernels do not take dp (not a positive multiple of 8, or more than
// 8 x 640 columns).
int deepsc_ce_wide_bwd_plan(int dp, int* out) {
  if (!takes(dp)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(dp);
  out[0] = p.slabs;
  out[1] = p.cluster;
  out[2] = p.block_slabs;
  out[3] = p.nc;
  out[4] = p.stages;
  out[5] = (int)p.smem;
  return 0;
}

// (rows of h per tile, vocab rows per tile, blocks of the dh kernel per SM
// from CUDA's occupancy calculator) into out[3] at padded width dp: what
// the wrapper cuts the vocab into splits by (with the SMs counted in
// clusters).
int deepsc_ce_wide_bwd_tiling_bf16(int dp, int* out) {
  if (!takes(dp)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(dp);
  const void* kernel = dh_kernel(p.block_slabs);
  const int err = set_smem(kernel, p.smem);
  if (err) return err;
  out[0] = wg::kRows;
  out[1] = kTile;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, kThreads, p.smem);
}

// h: contiguous bf16 (N, dp) and w: bf16 (V, dp), zero in columns
// [d, dp) (dp: d rounded up to a multiple of 8, the TMA's 16-byte rows),
// 16-byte aligned; b, db: f32 (V); labels: int32 (N); lse, g: f32 (N);
// dh: f32 (N, d); dw: f32 (V, d), with db, or both null for dh alone;
// dh_part: f32 workspace (splits, N, d). Every split must own at least one
// vocab tile of 32 rows. Returns cudaGetLastError() after the launches
// (0 = success).
int deepsc_ce_wide_bwd_bf16(const void* h, const void* w, const void* b,
                            const void* labels, const void* lse,
                            const void* g, void* dh, void* dw, void* db,
                            void* dh_part, int n, int d, int dp, int v,
                            int splits, void* stream) {
  if (n <= 0 || v <= 0 || d <= 0 || dp < d || dp - d >= 8 || !takes(dp) ||
      splits <= 0 || (dw == nullptr) != (db == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nvt = (v + kTile - 1) / kTile;
  const int tps = (nvt + splits - 1) / splits;
  if ((splits - 1) * tps >= nvt) return (int)cudaErrorInvalidValue;
  // h resident in the dh kernel, streamed in the dW kernel; W streamed in
  // the dh kernel, resident in the dW kernel: a map of each box height
  Maps m;
  int err = wg::make_map(&m.h64, h, n, dp, wg::kRows);
  if (!err) err = wg::make_map(&m.h32, h, n, dp, kTile);
  if (!err) err = wg::make_map(&m.w64, w, v, dp, wg::kRows);
  if (!err) err = wg::make_map(&m.w32, w, v, dp, kTile);
  if (err) return err;
  const Plan p = plan(dp);
  const Args x{(const float*)b, (const int*)labels, (const float*)lse,
               (const float*)g, nullptr, (float*)db, n, d, dp, v, tps,
               Geo{p.block_slabs, p.stages}};
  cudaStream_t st = (cudaStream_t)stream;
  float* dhf = (float*)dh;
  float* dwf = (float*)dw;
  float* part = (float*)dh_part;
#define DEEPSC_LAUNCH(A, B) \
  return launch<A, B>(m, x, dhf, dwf, part, splits, p, st)
  switch (p.block_slabs) {
    case 1: DEEPSC_LAUNCH(1, 0);
    case 2: DEEPSC_LAUNCH(1, 1);
    case 3: DEEPSC_LAUNCH(2, 1);
    case 4: DEEPSC_LAUNCH(2, 2);
    case 5: DEEPSC_LAUNCH(3, 2);
    case 6: DEEPSC_LAUNCH(3, 3);
    case 7: DEEPSC_LAUNCH(4, 3);
    case 8: DEEPSC_LAUNCH(4, 4);
    case 9: DEEPSC_LAUNCH(5, 4);
    default: DEEPSC_LAUNCH(5, 5);
  }
#undef DEEPSC_LAUNCH
}

}  // extern "C"
