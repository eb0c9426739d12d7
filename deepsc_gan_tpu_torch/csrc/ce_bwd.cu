// Online-softmax vocab cross-entropy backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernels `_dh_kernel` and `_dw_kernel` of
// deepsc_gan_tpu/ops/pallas/ce.py (the custom VJP of
// `pallas_softmax_xent`). With h (N, D), the vocab table W (V, D), bias b
// (V), labels y, the forward's lse (N) and the cotangent g (N) of ce,
//     P_nv = exp(h_n . W_v + b_v - lse_n) g_n - [v == y_n] g_n      (f32)
//     dh = Pc W (N, D),   dW = Pc^T h (V, D),   db = sum_n P_nv (V)
// all three in f32, where Pc is P rounded to the operand type before the
// products and the sums run in f32, as in the TPU kernels (db sums the
// unrounded P). The logits are recomputed tile by tile and never reach
// device memory. Rows past N have a zero cotangent and columns past V do
// not exist (the TPU kernels pad them with bias -1e30, which gives P = 0
// there).
//
// What bounds it: operations. At the training path (N = 1,984, D = 128,
// V = 22,234, bf16) the two products and the two logit recomputations are
// 4 x N D V = 22.6 G multiply-adds (45 GFLOP: 46 us at the bf16
// tensor-core rate) and 2 x N V = 88 M exponentials, against 6.7 MB read
// and 11.5 MB written (5 us at 3.35 TB/s).
//
// Design: two kernels, like the TPU's, because each product sums over a
// different axis and Hopper's blocks cannot carry a sum from one to the
// next. (The TPU's lax.scan backward computes both products from one
// logits recompute; on the card that would need atomics or an
// (N/64 x N x D) workspace for dh.)
// - dh: block (row tile, vocab split) keeps its 64 rows of h, walks its
//   range of vocab tiles and accumulates Pc W in registers; a third small
//   kernel adds the splits' partials in order.
// - dW, db: block (vocab tile of 64 rows) keeps its rows of W, walks every
//   row tile of h in row order and accumulates Pc^T h and sum_n P.
// - dh alone (dW and db not asked for, the caller passes them null): the
//   dh kernel and its split sum, and no dW/db kernel. The FGM attacks take
//   the gradient with respect to the received symbols through a loss whose
//   vocab table is held fixed.
// No atomics: the result is deterministic. bf16 only, on the tensor cores
// (csrc/wgmma_tile.cuh), one warpgroup per block (every f32 K4 is
// csrc/ce_bwd_tiled.cu's: exact f32 products on the CUDA cores): the
//   resident tile A (h for dh, W for dW) and the streamed tiles B (64 rows
//   of W, or of h) sit in shared memory as the TMA leaves them (128-byte
//   swizzle; a three-stage ring for B, one mbarrier per stage). Per tile,
//   wgmma m64n64k16 over D gives S = A . B^T (64 x 64, f32) in registers;
//   P is formed from it in f32 registers (ex2 on log2e-scaled values),
//   rounded to bf16 as the register A operand of the second product, and
//   wgmma m64n64k16 with B read MN-major (no transposed copy) adds P . B to
//   the (64 x D) f32 accumulator. (P gets registers of its own: written
//   over S, the products' accumulator, it made ptxas serialize every
//   product, warning C7515, at 10 % of the kernels' time.) For dW the
//   roles swap (S^T = W_t . h_t^T, so P^T is already in the A layout), and
//   db is each thread's sum of the unrounded P^T over its columns, merged
//   across the four threads of a row at the end in a fixed order.

#include "ce_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

// dh = sum over splits 0..S-1 of the partials, in order
__global__ void ce_dh_sum_kernel(const float* __restrict__ dh_part,
                                 float* __restrict__ dh, int n, int d,
                                 int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)n * d;
  if (e >= total) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += dh_part[sp * total + e];
  dh[e] = acc;
}

// ---- bf16: tensor cores ----

constexpr int kStages = 3;  // ring of streamed tiles of 64 rows

// Shared memory of either bf16 kernel: the resident 64-row tile, then the
// ring, each stage a 64-row tile.
struct Tiles {
  uint8_t* a;
  uint8_t* ring;
  int stage_bytes;
  __device__ Tiles(uint8_t* raw, int d)
      : a(wg::align_1024(raw)),
        ring(a + wg::tile_bytes(wg::kRows, d)),
        stage_bytes(wg::tile_bytes(wg::kRows, d)) {}
  __device__ uint8_t* stage(int it) const {
    return ring + (it % kStages) * stage_bytes;
  }
};

// Initializes the barriers (the ring's stages, then A's) and starts the
// loads of the resident tile at row a0 of amap and of the first streamed
// tiles (rows 64 (t0 + i) of bmap). Called by every thread.
__device__ __forceinline__ void start_loads(const Tiles& t, uint64_t* bar,
                                            const CUtensorMap* amap,
                                            const CUtensorMap* bmap, int a0,
                                            int t0, int count, int d) {
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) wg::mbar_init(&bar[i], 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::load_tile(t.a, amap, &bar[kStages], a0, wg::kRows, d);
    for (int i = 0; i < kStages && i < count; ++i)
      wg::load_tile(t.stage(i), bmap, &bar[i], (t0 + i) * wg::kRows,
                    wg::kRows, d);
  }
  wg::mbar_wait(&bar[kStages], 0);
}

// After the products of tile `it` have read its stage: once every warp is
// past them, refill the stage with tile it + kStages.
__device__ __forceinline__ void next_load(const Tiles& t, uint64_t* bar,
                                          const CUtensorMap* bmap, int it,
                                          int t0, int count, int d) {
  __syncthreads();
  if (threadIdx.x == 0 && it + kStages < count)
    wg::load_tile(t.stage(it), bmap, &bar[it % kStages],
                  (t0 + it + kStages) * wg::kRows, wg::kRows, d);
}

// Stores the thread's part of a (64 x D) f32 accumulator: rows
// row0 + r + 8 i (i < 2) below `rows`, columns 64 s + 8 q + 2 (lane % 4)
// (+ 0, 1) below d, into the row-major (rows, d) array out.
template <int NC>
__device__ __forceinline__ void store_acc(const float (&acc)[NC][32],
                                          float* out, int row0, int r,
                                          int rows, int d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int s = 0; s < NC; ++s)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = 64 * s + 8 * q + 2 * (lane & 3);
        if (col < d)
          *reinterpret_cast<float2*>(out + (size_t)row * d + col) =
              make_float2(acc[s][4 * q + 2 * i], acc[s][4 * q + 2 * i + 1]);
      }
  }
}

// dh partial of block (row tile, split): sum over its vocab tiles of
// Pc W_t, into dh_part[split]
template <int NC>
__global__ void __launch_bounds__(wg::kThreads)
ce_dh_wgmma_kernel(const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ b,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse_in,
                   const float* __restrict__ g_in,
                   float* __restrict__ dh_part, int n, int d, int v,
                   int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[kStages + 1];
  const Tiles t(smem_raw, d);
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * wg::kRows;
  const int split = blockIdx.y;
  const int nvt = (v + wg::kRows - 1) / wg::kRows;
  const int t0 = split * tiles_per_split;
  const int count = min(t0 + tiles_per_split, nvt) - t0;

  // rows r and r + 8 of the tile; columns 8 q + 2 (lane % 4) + e of a
  // vocab tile (q < 8, e < 2)
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
  int lab[2];
  float lse2[2], g[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    const bool ok = row < n;
    lab[i] = ok ? labels[row] : -1;
    lse2[i] = ok ? lse_in[row] * wg::kLog2e : 0.f;
    g[i] = ok ? g_in[row] : 0.f;
  }
  float acc[NC][32];  // overwritten by the first tile's products
  start_loads(t, bar, &hmap, &wmap, row0, t0, count, d);
  const uint32_t h_addr = wg::smem_u32(t.a);

  for (int it = 0; it < count; ++it) {
    const int c0 = (t0 + it) * wg::kRows + 2 * (lane & 3);
    float bias[16];  // 8-byte loads (c0 is even) but on a ragged tile
    if ((t0 + it + 1) * wg::kRows <= v) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(c0 + 8 * q + b));
        bias[2 * q] = x.x;
        bias[2 * q + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * q + e;
          bias[2 * q + e] = c < v ? __ldg(b + c) : 0.f;
        }
    }
    wg::mbar_wait(&bar[it % kStages], (it / kStages) & 1);
    const uint32_t w_addr = wg::smem_u32(t.stage(it));
    float p[32];
    wg::logits<wg::kRows, NC>(p, h_addr, w_addr, d);
    float pp[32];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * q + e;
          const float x = p[4 * q + 2 * i + e];
          float y = wg::exp2_approx(
                        fmaf(x + bias[2 * q + e], wg::kLog2e, -lse2[i])) *
                    g[i];
          if (c == lab[i]) y -= g[i];
          pp[4 * q + 2 * i + e] = c < v ? y : 0.f;
        }
    uint32_t a[16];
    wg::to_a(pp, a);
    wg::accumulate(acc, a, w_addr, it == 0);
    next_load(t, bar, &wmap, it, t0, count, d);
  }
  store_acc(acc, dh_part + (size_t)split * n * d, row0, r, n, d);
}

// dW and db of block (vocab tile): sums over every row tile of h, in
// order, of Pc^T h_t and of P^T
template <int NC>
__global__ void __launch_bounds__(wg::kThreads)
ce_dw_wgmma_kernel(const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ b,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse_in,
                   const float* __restrict__ g_in, float* __restrict__ dw,
                   float* __restrict__ db, int n, int d, int v) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[kStages + 1];
  const Tiles t(smem_raw, d);
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * wg::kRows;
  const int count = (n + wg::kRows - 1) / wg::kRows;

  // vocab rows r and r + 8 of the tile; rows 8 q + 2 (lane % 4) + e of a
  // tile of h (q < 8, e < 2)
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
  int vid[2];
  float bias2[2], dbs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    vid[i] = col0 + r + 8 * i;
    bias2[i] = vid[i] < v ? b[vid[i]] * wg::kLog2e : 0.f;
  }
  float acc[NC][32];  // overwritten by the first tile's products
  start_loads(t, bar, &wmap, &hmap, col0, 0, count, d);
  const uint32_t w_addr = wg::smem_u32(t.a);

  for (int it = 0; it < count; ++it) {
    const int r0 = it * wg::kRows + 2 * (lane & 3);
    int lab[16];
    float lse2[16], g[16];  // 8-byte loads (r0 is even) but on a ragged tile
    if ((it + 1) * wg::kRows <= n) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = r0 + 8 * q;
        const int2 l = __ldg(reinterpret_cast<const int2*>(labels + row));
        const float2 x = __ldg(reinterpret_cast<const float2*>(lse_in + row));
        const float2 y = __ldg(reinterpret_cast<const float2*>(g_in + row));
        lab[2 * q] = l.x;
        lab[2 * q + 1] = l.y;
        lse2[2 * q] = x.x * wg::kLog2e;
        lse2[2 * q + 1] = x.y * wg::kLog2e;
        g[2 * q] = y.x;
        g[2 * q + 1] = y.y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + 8 * q + e;
          const bool ok = row < n;
          lab[2 * q + e] = ok ? labels[row] : -1;
          lse2[2 * q + e] = ok ? lse_in[row] * wg::kLog2e : 0.f;
          g[2 * q + e] = ok ? g_in[row] : 0.f;
        }
    }
    wg::mbar_wait(&bar[it % kStages], (it / kStages) & 1);
    const uint32_t h_addr = wg::smem_u32(t.stage(it));
    float p[32];
    wg::logits<wg::kRows, NC>(p, w_addr, h_addr, d);
    float pp[32];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 2 * q + e;
          float x = p[4 * q + 2 * i + e];
          x = wg::exp2_approx(fmaf(x, wg::kLog2e, bias2[i] - lse2[j])) * g[j];
          if (vid[i] == lab[j]) x -= g[j];
          dbs[i] += x;
          pp[4 * q + 2 * i + e] = x;
        }
    uint32_t a[16];
    wg::to_a(pp, a);
    wg::accumulate(acc, a, h_addr, it == 0);
    next_load(t, bar, &hmap, it, 0, count, d);
  }
  store_acc(acc, dw, col0, r, v, d);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dbs[i] += __shfl_xor_sync(0xffffffffu, dbs[i], 1);
    dbs[i] += __shfl_xor_sync(0xffffffffu, dbs[i], 2);
    if ((lane & 3) == 0 && vid[i] < v) db[vid[i]] = dbs[i];
  }
}

size_t smem_bytes_bf16(int d) {
  return 1024 + (size_t)(1 + kStages) * wg::tile_bytes(wg::kRows, d);
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// vocab tiles of 64 rows per split, or -1 when the arguments are bad or a
// split would own no tile
int split_tiles(int n, int d, int v, int splits) {
  if (n <= 0 || v <= 0 || d <= 0 || d > ce::kMaxD || splits <= 0) return -1;
  const int nvt = (v + wg::kRows - 1) / wg::kRows;
  const int tps = (nvt + splits - 1) / splits;
  return (splits - 1) * tps >= nvt ? -1 : tps;
}

// What the wrapper cuts the vocab into splits by, into out[3]: `rows` of
// h per tile, `vocab_rows` of W per tile, and how many blocks of the
// dh kernel `kernel` (`threads` threads, `smem` bytes of dynamic shared
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

const void* dh_wgmma_kernel(int d) {
  switch (wg::slabs(d)) {
    case 1: return (const void*)ce_dh_wgmma_kernel<1>;
    case 2: return (const void*)ce_dh_wgmma_kernel<2>;
    case 3: return (const void*)ce_dh_wgmma_kernel<3>;
    default: return (const void*)ce_dh_wgmma_kernel<4>;
  }
}

int sum_splits(const void* dh_part, void* dh, int n, int d, int splits,
               cudaStream_t st) {
  const size_t total = (size_t)n * d;
  ce_dh_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float*)dh_part, (float*)dh, n, d, splits);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_bf16(const CUtensorMap& hmap, const CUtensorMap& wmap,
                const void* b, const void* labels, const void* lse,
                const void* g, void* dh, void* dw, void* db, void* dh_part,
                int n, int d, int v, int splits, int tps, cudaStream_t st) {
  const size_t smem = smem_bytes_bf16(d);
  int err = set_smem((const void*)ce_dh_wgmma_kernel<NC>, smem);
  if (err) return err;
  err = set_smem((const void*)ce_dw_wgmma_kernel<NC>, smem);
  if (err) return err;
  ce_dh_wgmma_kernel<NC>
      <<<dim3((n + wg::kRows - 1) / wg::kRows, splits), wg::kThreads, smem,
         st>>>(hmap, wmap, (const float*)b, (const int*)labels,
               (const float*)lse, (const float*)g, (float*)dh_part, n, d, v,
               tps);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = sum_splits(dh_part, dh, n, d, splits, st);
  if (err || dw == nullptr) return err;
  ce_dw_wgmma_kernel<NC><<<(v + wg::kRows - 1) / wg::kRows, wg::kThreads,
                           smem, st>>>(
      hmap, wmap, (const float*)b, (const int*)labels, (const float*)lse,
      (const float*)g, (float*)dw, (float*)db, n, d, v);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of either product kernel needs.
size_t deepsc_ce_bwd_smem_bytes_bf16(int d) { return smem_bytes_bf16(d); }

// The splits' terms at width d, out[3] as `tiling` fills it for the dh
// kernel of the dtype on the current device.
int deepsc_ce_bwd_tiling_bf16(int d, int* out) {
  if (d <= 0 || d > ce::kMaxD || d % 16) return (int)cudaErrorInvalidValue;
  return tiling(dh_wgmma_kernel(d), wg::kThreads, smem_bytes_bf16(d),
                wg::kRows, wg::kRows, out);
}

// h: contiguous bf16 (N, D), D a multiple of 16 up to 256 (one wgmma
// k-step is 16 columns); w: contiguous bf16 (V, D); b, db: f32 (V);
// labels: int32 (N); lse, g: f32 (N); dh: f32 (N, D); dw: f32 (V, D);
// dh_part: f32 workspace (splits, N, D). Every split must own at least one
// vocab tile of 64 rows. With dw and db both null, dh alone: the dh kernel
// and its split sum, no dW/db kernel (the gradient with respect to h of a
// loss whose vocab table is held fixed). Returns cudaGetLastError() after
// the launches (0 = success).
int deepsc_ce_bwd_bf16(const void* h, const void* w, const void* b,
                       const void* labels, const void* lse, const void* g,
                       void* dh, void* dw, void* db, void* dh_part, int n,
                       int d, int v, int splits, void* stream) {
  const int tps = split_tiles(n, d, v, splits);
  if (tps < 0 || d % 16 || (dw == nullptr) != (db == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  int err = wg::make_map(&hmap, h, n, d, wg::kRows);
  if (err) return err;
  err = wg::make_map(&wmap, w, v, d, wg::kRows);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (wg::slabs(d)) {
    case 1:
      return launch_bf16<1>(hmap, wmap, b, labels, lse, g, dh, dw, db,
                            dh_part, n, d, v, splits, tps, st);
    case 2:
      return launch_bf16<2>(hmap, wmap, b, labels, lse, g, dh, dw, db,
                            dh_part, n, d, v, splits, tps, st);
    case 3:
      return launch_bf16<3>(hmap, wmap, b, labels, lse, g, dh, dw, db,
                            dh_part, n, d, v, splits, tps, st);
    default:
      return launch_bf16<4>(hmap, wmap, b, labels, lse, g, dh, dw, db,
                            dh_part, n, d, v, splits, tps, st);
  }
}

}  // extern "C"
