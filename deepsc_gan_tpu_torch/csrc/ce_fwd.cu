// Online-softmax vocab cross-entropy forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `_fwd_kernel` of deepsc_gan_tpu/ops/pallas/ce.py
// (reached through `pallas_softmax_xent` / `fused_ce_loss`). For each row n
// of h (N, D) with label y_n, over the vocab table W (V, D) and bias b (V)
//     lse_n = log sum_v exp(h_n . W_v + b_v),   ce_n = lse_n - (h_n . W_y + b_y)
// with f32 products and sums of bf16 operands. The (N, V) logits never
// reach device memory: each block recomputes tiles of them in registers
// and keeps a running max and a rescaled sum of exponentials, as the TPU
// kernel does over its vocab grid axis. The TPU kernel pads W and b to a
// whole number of vocab tiles (bias -1e30 on the padding, a copy of the
// table per call); here the last tile is masked instead, which gives the
// same sums: a padded column adds exp(-1e30 - m) = 0.
//
// What bounds it: operations. At the training path (N = 64 x 31 = 1,984,
// D = 128, V = 22,234, bf16) one call does 2 N D V = 11.3 GFLOP (11 us at
// the bf16 tensor-core rate) and N V = 44 M exponentials (about 11 us on
// the SFUs), and reads 6.2 MB (2 us at 3.35 TB/s).
//
// Design: the TPU kernel's grid runs its vocab axis in order on one core;
// here blocks run in parallel, so the vocab axis is cut into `splits`
// contiguous ranges. Block (row tile, split) keeps its 64 rows of h and
// walks its range of vocab tiles; one (max, sum, gold) per (split, row)
// goes to a workspace, and a second kernel merges the splits of each row in
// order and writes ce and lse. No atomics: the result is deterministic.
// bf16 only, on the tensor cores (csrc/wgmma_tile.cuh; every f32 K3 is
// csrc/ce_fwd_tiled.cu's, exact f32 on the CUDA cores), one warpgroup per
// block. The h tile stays in shared memory; vocab tiles of 128 rows of W
// stream through a two-stage ring filled by the TMA, one mbarrier per
// stage. The logits S = h_t . W_t^T (64 x 128, f32) come from wgmma
// m64n128k16 over D; the bias, the running max, the rescaled sum of
// exponentials (ex2 on log2e-scaled values) and the gold logit are taken
// in registers, each thread over the columns it holds of its two rows, and
// the four threads of a quad (one row) are merged by shuffles once at the
// end. The next tile's TMA load runs under this tile's epilogue, and two
// blocks share an SM, so one block's exponentials run under the other's
// products.

#include "ce_online.cuh"

namespace {

using ceo::kTV;
constexpr int kStages = 2;   // ring of vocab tiles

__global__ void __launch_bounds__(wg::kThreads)
ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap hmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ b,
                    const int* __restrict__ labels,
                    float* __restrict__ part, int n, int d, int v,
                    int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[kStages + 1];  // the ring's stages, then h
  uint8_t* hs = wg::align_1024(smem_raw);
  uint8_t* ring = hs + wg::tile_bytes(wg::kRows, d);
  const int stage_bytes = wg::tile_bytes(kTV, d);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * wg::kRows;
  const int split = blockIdx.y;
  const int nvt = (v + kTV - 1) / kTV;
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
                    (t0 + i) * kTV, kTV, d);
  }

  const int r = (tid >> 5) * 16 + (lane >> 2);
  ceo::Softmax sm;
  sm.init(labels, row0 + r, n);

  wg::mbar_wait(&bar[kStages], 0);
  const uint32_t h_addr = wg::smem_u32(hs);
  for (int it = 0; it < count; ++it) {
    const int col0 = (t0 + it) * kTV;
    const int c0 = col0 + 2 * (lane & 3);
    float bias[32];
    ceo::load_bias(bias, b, col0, c0, v);
    uint8_t* ws = ring + (it % kStages) * stage_bytes;
    wg::mbar_wait(&bar[it % kStages], (it / kStages) & 1);
    float acc[64];
    wg::logits<kTV, wg::kMaxSlabs>(acc, h_addr, wg::smem_u32(ws), d);
    __syncthreads();  // every warp's products have read the stage
    if (tid == 0 && it + kStages < count)
      wg::load_tile(ws, &wmap, &bar[it % kStages],
                    (t0 + it + kStages) * kTV, kTV, d);
    sm.add_tile(acc, bias, col0, c0, v);
  }
  sm.store(part, split, row0 + r, n, lane);
}

size_t smem_bytes_bf16(int d) {
  return 1024 + (size_t)wg::tile_bytes(wg::kRows, d) +
         (size_t)kStages * wg::tile_bytes(kTV, d);
}

// vocab tiles per split (ceo::split_tiles), or -1 past the widths the
// kernels take
int split_tiles(int n, int d, int v, int splits, int tv) {
  if (d <= 0 || d > ce::kMaxD) return -1;
  return ceo::split_tiles(n, v, splits, tv);
}

using ceo::combine;
using ceo::set_smem;
using ceo::tiling;

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the partial kernel needs.
size_t deepsc_ce_fwd_smem_bytes_bf16(int d) { return smem_bytes_bf16(d); }

// The splits' terms at width d, out[3] as `tiling` fills it for the
// partial kernel of the dtype on the current device.
int deepsc_ce_fwd_tiling_bf16(int d, int* out) {
  if (d <= 0 || d > ce::kMaxD || d % 16) return (int)cudaErrorInvalidValue;
  return tiling((const void*)ce_fwd_wgmma_kernel, wg::kThreads,
                smem_bytes_bf16(d), wg::kRows, kTV, out);
}

// h: contiguous bf16 (N, D), D a multiple of 16 up to 256 (one wgmma
// k-step is 16 columns); w: contiguous bf16 (V, D); b: f32 (V); labels:
// int32 (N); ce_out, lse_out: f32 (N); part: f32 workspace (splits, N, 3).
// Every split must own at least one vocab tile of 128 rows. Returns
// cudaGetLastError() after the launches (0 = success).
int deepsc_ce_fwd_bf16(const void* h, const void* w, const void* b,
                       const void* labels, void* ce_out, void* lse_out,
                       void* part, int n, int d, int v, int splits,
                       void* stream) {
  const int tps = split_tiles(n, d, v, splits, kTV);
  if (tps < 0 || d % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  int err = wg::make_map(&hmap, h, n, d, wg::kRows);
  if (err) return err;
  err = wg::make_map(&wmap, w, v, d, kTV);
  if (err) return err;
  const size_t smem = smem_bytes_bf16(d);
  err = set_smem((const void*)ce_fwd_wgmma_kernel, smem);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  ce_fwd_wgmma_kernel<<<dim3((n + wg::kRows - 1) / wg::kRows, splits),
                        wg::kThreads, smem, st>>>(
      hmap, wmap, (const float*)b, (const int*)labels, (float*)part, n, d,
      v, tps);
  err = (int)cudaGetLastError();
  if (err) return err;
  return combine(part, ce_out, lse_out, n, splits, st);
}

}  // extern "C"
