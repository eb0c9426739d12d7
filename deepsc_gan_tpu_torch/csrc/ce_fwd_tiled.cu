// Online-softmax vocab cross-entropy forward (K3) in f32 at any width D, on
// the CUDA cores of Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` of deepsc_gan_tpu/ops/pallas/ce.py
// for every f32 call (`--dtype float32`: the main model's D = 128, the
// widened decoder's 200, the wide-heads model's 640, and any D >= 1; bf16
// runs csrc/ce_fwd.cu and csrc/ce_wide_fwd.cu on the tensor cores). Same
// function and roundings as the plain version: with h (N, D), W (V, D) f32,
// bias b (V) f32 and labels y,
//     lse_n = log sum_v exp(h_n . W_v + b_v),  ce_n = lse_n - (h_n . W_y + b_y)
// every product in exact f32 on the CUDA cores (no TF32) and f32 sums; the
// logits never reach device memory.
//
// What bounds it: operations. At N = 1,984, V = 22,234 the logits are
// 2 N D V = 11.3 GFLOP at D = 128 (0.17 ms at the f32 CUDA-core rate of 67
// TFLOP/s) and 56.5 GFLOP at D = 640 (0.84 ms), beside N V = 44 M
// exponentials. The designs before this one (csrc/ce_fwd.cu's f32 kernel
// up to D = 256, a wide kernel with D streamed in chunks of 32 past it)
// formed 64 x 64 tiles with 4 x 4 logits a thread, one shared-memory load
// for every four FMAs, and took 3.662 ms at D = 640 on an H100 80GB HBM3 at
// 700 W.
//
// Design: csrc/ce_bwd_tiled.cu's P tile (csrc/ce_tiled.cuh). Block (128 rows
// of h, vocab split) walks its split's vocab tiles of 128 rows in order; per
// tile the 128 x 128 logits, 8 x 8 a thread, D streamed through shared
// memory in chunks of 16 columns (the next chunk loaded while this one is
// multiplied), each logit summed over d in order 0..D-1 by fmaf, then
// rounded once more by the bias add. A row's 128 logits of the tile lie
// with the 16 threads of one half-warp: each takes the max of its 8, the
// half-warp the max of the 16 (xor shuffles), and then each the sum of its
// 8 exponentials in column order, the half-warp their sum (xor shuffles in
// the order 1, 2, 4, 8, which gives every lane the same bits); the row's
// running (max, sum), in shared memory, is rescaled to the new max by the
// half-warp's first thread (held in registers instead, they spilled: 2 %
// slower at D = 640 on an H100 80GB HBM3 at 700 W, scripts/kernels_ab.py
// against an edited copy). The thread that holds the label's column writes
// the gold logit to shared memory. One (max, sum, gold) per (split, row)
// goes to a workspace, and a second kernel merges each row's splits in
// order. No atomics: every sum in a fixed order, the same bits on every
// call. The kernels allocate nothing.

#include "ce_tiled.cuh"

namespace {

using namespace tiled;

constexpr float NEG = -1e30f;  // the TPU kernel's running-max start

// block (row tile, vocab split): (max, sum, gold) of each of its rows over
// the split's vocab tiles, into part (splits, N, 3)
__global__ void __launch_bounds__(kThreads, 2)
ce_fwd_tiled_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b,
                    const int* __restrict__ labels, float* __restrict__ part,
                    int n, int d, int v, int tiles_per_split) {
  __shared__ __align__(16) float as[2][kBK][kStride];
  __shared__ __align__(16) float bs[2][kBK][kStride];
  __shared__ int lab_s[kBM];
  __shared__ float gold_s[kBM];
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
    const int r = row0 + threadIdx.x;
    lab_s[threadIdx.x] = r < n ? __ldg(labels + r) : -1;
    gold_s[threadIdx.x] = 0.f;
    m_s[threadIdx.x] = NEG;
    s_s[threadIdx.x] = 0.f;
  }  // read after tile_product's first barrier
  DepthAlongRows<float> la{h, n, d, d, row0};
  for (int t = t0; t < t1; ++t) {
    const int col0 = t * kBN;
    DepthAlongRows<float> lb{w, v, d, d, col0};
    float acc[8][8];
    tile_product<float>(acc, la, lb, 0, d, as, bs, Nothing{});
    float bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + at(tx, j);
      bias[j] = c < v ? __ldg(b + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int lab = lab_s[at(ty, i)];
      float cm = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + at(tx, j);
        acc[i][j] = __fadd_rn(acc[i][j], bias[j]);
        if (c < v) cm = fmaxf(cm, acc[i][j]);
        if (c == lab) gold_s[at(ty, i)] = acc[i][j];
      }
      const float m_old = m_s[at(ty, i)];
      const float mn = fmaxf(m_old, half_warp_max(cm));
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (col0 + at(tx, j) < v)
          se = __fadd_rn(se, expf(__fsub_rn(acc[i][j], mn)));
      se = half_warp_sum(se);
      // every lane read m_s before the shuffles that lane 0 waits on
      if (tx == 0) {
        s_s[at(ty, i)] = __fadd_rn(
            __fmul_rn(s_s[at(ty, i)], expf(__fsub_rn(m_old, mn))), se);
        m_s[at(ty, i)] = mn;
      }
    }
  }
  __syncthreads();  // every gold logit is in gold_s
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + at(ty, i);
      if (r >= n) continue;
      float* out = part + ((size_t)split * n + r) * 3;
      out[0] = m_s[at(ty, i)];
      out[1] = s_s[at(ty, i)];
      out[2] = gold_s[at(ty, i)];
    }
  }
}

// one thread per row: merge the splits in order; lse = m + log(s),
// ce = lse - gold
__global__ void ce_fwd_tiled_combine_kernel(const float* __restrict__ part,
                                            float* __restrict__ ce_out,
                                            float* __restrict__ lse_out,
                                            int n, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float mm = NEG;
  for (int sp = 0; sp < splits; ++sp)
    mm = fmaxf(mm, part[((size_t)sp * n + row) * 3]);
  float ss = 0.f, gg = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = part + ((size_t)sp * n + row) * 3;
    ss = __fadd_rn(ss, __fmul_rn(p[1], expf(__fsub_rn(p[0], mm))));
    gg = __fadd_rn(gg, p[2]);
  }
  const float lse = __fadd_rn(mm, logf(ss));
  lse_out[row] = lse;
  ce_out[row] = __fsub_rn(lse, gg);
}

}  // namespace

extern "C" {

// (rows of h per tile, vocab rows per tile, blocks of the partial kernel
// per SM) into out[3], on the current device: what the wrapper cuts the
// vocab into splits by.
int deepsc_ce_fwd_tiled_tiling_f32(int d, int* out) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  out[0] = kBM;
  out[1] = kBN;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], ce_fwd_tiled_kernel, kThreads, 0);
}

// h: contiguous f32 (N, D), any D >= 1; w: contiguous f32 (V, D); b: f32
// (V); labels: int32 (N); ce_out, lse_out: f32 (N); part: f32 workspace
// (splits, N, 3). Every split must own at least one vocab tile of 128
// rows. Returns cudaGetLastError() after the launches (0 = success).
int deepsc_ce_fwd_tiled_f32(const void* h, const void* w, const void* b,
                            const void* labels, void* ce_out, void* lse_out,
                            void* part, int n, int d, int v, int splits,
                            void* stream) {
  if (n <= 0 || d <= 0 || v <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int vt = (v + kBN - 1) / kBN;
  const int tps = (vt + splits - 1) / splits;
  if ((splits - 1) * tps >= vt) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ce_fwd_tiled_kernel<<<dim3((n + kBM - 1) / kBM, splits), kThreads, 0,
                        st>>>((const float*)h, (const float*)w,
                              (const float*)b, (const int*)labels,
                              (float*)part, n, d, v, tps);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  ce_fwd_tiled_combine_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)part, (float*)ce_out, (float*)lse_out, n, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
