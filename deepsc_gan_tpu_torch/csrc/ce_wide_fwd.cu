// Online-softmax vocab cross-entropy forward at any width D, bf16, on
// Hopper's tensor cores (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` of deepsc_gan_tpu/ops/pallas/ce.py
// where the tuned K3 (csrc/ce_fwd.cu: D a multiple of 16 up to 256, the
// whole 64-row tile of h resident) does not take the width: the wide-heads
// decoder (`--decoder-d-model 640`), the widened one (200) and any other
// bf16 D run here. Every f32 width runs csrc/ce_fwd_tiled.cu on the CUDA
// cores (exact f32 products, which the f32 step-parity checks need). Same
// function and roundings as the tuned K3: with h (N, D) and W (V, D) bf16,
// bias b (V) f32 and labels y,
//     lse_n = log sum_v exp(h_n . W_v + b_v),  ce_n = lse_n - (h_n . W_y + b_y)
// with f32 products and sums, and the (N, V) logits never in device memory.
//
// What bounds it: operations. At N = 1,984, D = 640, V = 22,234 one call
// does 2 N D V = 56.5 GFLOP (0.057 ms at the bf16 tensor-core rate) and
// N V = 44 M exponentials, and reads 31 MB (0.009 ms at 3.35 TB/s). The
// design before this one (CUDA-core tiles of 64 x 64 in f32, bf16
// converted as it was staged) took 5.3 ms there.
//
// Design: the tuned K3's tile step with D turned into a streamed k-loop.
// The output is only (max, sum, gold) a row, so the accumulator does not
// grow with D: a block (one warpgroup) keeps one 64 x 128 f32 tile of logits
// S = h_t . W_t^T (wgmma m64n128k16, 64 registers a thread) for its 64 rows
// of h and a vocab tile of 128 rows of W, and only the operands stream. A
// ring stage holds one 64-column k-chunk of h's tile and of W's tile (8 +
// 16 KB, TMA loads into 128-byte-swizzled slabs, one mbarrier a stage:
// `ceo::Ring` of csrc/ce_online.cuh, which the wide K6 shares), so
// shared memory is the same at every D and three blocks share an SM: one
// block's exponentials run under the others' products. Three stages (72
// KB) took 0.101 / 0.112 / 0.137 ms at D = 200 / 512 / 640 where four (two
// blocks an SM) took 0.113 / 0.174 / 0.211 and two 0.100 / 0.137 / 0.164
// (scripts/ce_wide_fwd_variants.py on an H100 80GB HBM3 at 700 W, N =
// 1,984, V = 22,234; PERF.md). The chunks of
// a vocab tile accumulate into S, each chunk's products waited for while the
// next chunk's run, its stage then refilled with the chunk `kStages` ahead
// (across vocab tiles, so the next tile's loads run under this tile's
// softmax). The softmax runs on S in registers as in the tuned K3
// (csrc/ce_online.cuh: ex2 on log2(e)-scaled values, the quads merged once
// at the end), block (row tile, vocab split) writes its rows' (max, sum,
// gold) and a second kernel merges the splits in order. No atomics: the
// same bits on every call. The TMA fills columns past D with zeros (a
// k-step past D adds exact zeros; the k-steps wholly past D are not
// issued); a D that is not a multiple of 8 comes as zero-padded copies of
// width dp (the TMA's 16-byte rows). Keeping h's whole tile resident and
// streaming W alone reads a third less a tile but lets fewer blocks share
// an SM: faster at D = 200, slower at 512 (two blocks an SM) and 640 (one)
// (scripts/ce_wide_fwd_variants.py builds it).

#include "ce_online.cuh"

namespace {

using ceo::kTV;

constexpr int kStages = 3;
using Ring = ceo::Ring<kStages>;

// dynamic shared memory a block needs (the same at every width)
size_t smem_bytes() { return Ring::kBytes; }

// block (row tile, vocab split): (max, sum, gold) of its 64 rows over its
// vocab tiles, into part[split]
__global__ void __launch_bounds__(wg::kThreads)
ce_fwd_wide_tc_kernel(const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ b,
                      const int* __restrict__ labels,
                      float* __restrict__ part, int n, int dp, int v,
                      int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[kStages];  // the ring's stages

  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * wg::kRows;
  const int split = blockIdx.y;
  const int nvt = (v + kTV - 1) / kTV;
  const int t0 = split * tiles_per_split;
  const int count = min(t0 + tiles_per_split, nvt) - t0;
  Ring ring;
  ring.begin(&hmap, &wmap, smem_raw, bar, row0, t0, count, dp);

  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
  ceo::Softmax sm;
  sm.init(labels, row0 + r, n);
  for (int it = 0; it < count; ++it) {
    const int col0 = (t0 + it) * kTV;
    const int c0 = col0 + 2 * (lane & 3);
    float bias[32];
    ceo::load_bias(bias, b, col0, c0, v);
    float acc[64];
    ring.tile(acc, it);
    sm.add_tile(acc, bias, col0, c0, v);
  }
  sm.store(part, split, row0 + r, n, lane);
}

bool takes(int dp) { return dp > 0 && dp % 8 == 0; }

}  // namespace

extern "C" {

// How the library cuts a padded width dp, into out[3]: its k-chunks of 64
// columns, the ring's stages, and a block's dynamic shared memory in bytes.
// Returns 0, or cudaErrorInvalidValue where dp is not a positive multiple
// of 8.
int deepsc_ce_wide_fwd_plan(int dp, int* out) {
  if (!takes(dp)) return (int)cudaErrorInvalidValue;
  out[0] = wg::slabs(dp);
  out[1] = kStages;
  out[2] = (int)smem_bytes();
  return 0;
}

// (rows of h per tile, vocab rows per tile, blocks per SM from CUDA's
// occupancy calculator) into out[3] at padded width dp: what the wrapper
// cuts the vocab into splits by.
int deepsc_ce_wide_fwd_tiling_bf16(int dp, int* out) {
  if (!takes(dp)) return (int)cudaErrorInvalidValue;
  return ceo::tiling((const void*)ce_fwd_wide_tc_kernel, wg::kThreads,
                     smem_bytes(), wg::kRows, kTV, out);
}

// h: contiguous bf16 (N, dp) and w: bf16 (V, dp), zero in the columns past
// D (dp: D rounded up to a multiple of 8, the TMA's 16-byte rows), 16-byte
// aligned; b: f32 (V); labels: int32 (N); ce_out, lse_out: f32 (N); part:
// f32 workspace (splits, N, 3). Every split must own at least one vocab
// tile of 128 rows. Returns cudaGetLastError() after the launches (0 =
// success).
int deepsc_ce_wide_fwd_bf16(const void* h, const void* w, const void* b,
                            const void* labels, void* ce_out, void* lse_out,
                            void* part, int n, int dp, int v, int splits,
                            void* stream) {
  const int tps = ceo::split_tiles(n, v, splits, kTV);
  if (tps < 0 || !takes(dp)) return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  int err = wg::make_map(&hmap, h, n, dp, wg::kRows);
  if (!err) err = wg::make_map(&wmap, w, v, dp, kTV);
  if (err) return err;
  const size_t smem = smem_bytes();
  err = ceo::set_smem((const void*)ce_fwd_wide_tc_kernel, smem);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  ce_fwd_wide_tc_kernel<<<dim3((n + wg::kRows - 1) / wg::kRows, splits),
                          wg::kThreads, smem, st>>>(
      hmap, wmap, (const float*)b, (const int*)labels, (float*)part, n, dp,
      v, tps);
  err = (int)cudaGetLastError();
  if (err) return err;
  return ceo::combine(part, ce_out, lse_out, n, splits, st);
}

}  // extern "C"
