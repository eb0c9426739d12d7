// Fused beam-candidate scorer (K6) by a radix select, at any k and any width
// D, f32 and bf16, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_topk_kernel` of deepsc_gan_tpu/ops/pallas/
// topk.py where neither the tuned K6 (csrc/topk.cu: k up to 8, D a multiple
// of 8 up to 256) nor the bf16 tensor-core wide kernel (csrc/topk_wide_mma.cu:
// k up to 64, or its long path at 65..256 over V up to 25,000) takes the
// call: every f32 call at k past 8 or another D (`--dtype float32
// --beam-size 9` on the widened decoder, d_model 200), and bf16 past
// k = 256 or V = 25,000 (`--beam-size 1000`; `--beam-size` takes 1..V, so
// k = V, a full sort of the vocab, too). Same function as the other K6
// kernels: per row of h (N, D) over the vocab table W (V, D) and bias b (V)
// f32, the k largest logits h . W_v + b_v in descending order, ties to the
// lowest vocab index, their int32 indices, and the row's logsumexp, with
// f32 products (exact f32 on the CUDA cores for f32 operands, no TF32;
// exact for bf16 operands on the tensor cores) and f32 sums.
//
// What bounds it: at N = 256 rows, D = 200, V = 22,234 the logits are
// 2.28 GFLOP (0.034 ms at the f32 CUDA-core rate of 67 TFLOP/s, 0.0023 in
// bf16 on the tensor cores) and 17.8 MB of f32 W. The design before this
// one (csrc/topk_wide.cu) ran k rounds of a block argmax over each vocab
// split and k more over the splits' lists: O(k V) reads a row and 2 k
// barriers, 193.98 ms at k = 1,000 in bf16 on an H100 80GB HBM3 at 700 W,
// where `torch.topk` + `logsumexp` take 0.275.
//
// Design, two kernels:
// (1) the logits, written once to the caller's (N, V) f32 workspace, with
//     each (vocab split, row)'s running (max, sum of exponentials). f32:
//     block (128 rows of h, vocab split) walks 128-row tiles of W on the
//     CUDA cores, 8 x 8 products a thread, D streamed through shared
//     memory in chunks of 8 columns (the next chunk loaded into registers
//     while this one is multiplied), every sum over d in order 0..D-1 by
//     fmaf. bf16: the wide K3's streamed wgmma tile (`ceo::Ring` and
//     `ceo::Softmax` of csrc/ce_online.cuh), block (64 rows, vocab split).
// (2) a block per row selects: the 64-bit key of each logit (its
//     order-preserving bits, -0 as +0, then the complement of its index:
//     every key distinct, a larger key first, ties to the lower index) is
//     formed on the fly from the row's logits in the workspace (four loads
//     a thread in flight); a radix select, a byte a pass from the top (the
//     index's bytes only where V - 1 reaches them), finds the bytes that
//     single out the k largest keys, its passes counting a compacted copy
//     of the keys still in play in shared memory once they are few (at k =
//     V every key is taken without a pass); those k keys are gathered (in
//     any order, one atomic a warp) and sorted in shared memory (or, past
//     what one block holds, in a caller's scratch row) by a bitonic
//     network whose comparators past k are left out (k is not rounded up:
//     the network treats the places past k as the smallest keys, which
//     never move); the (max, sum) pairs are merged in split order into the
//     logsumexp. The histogram counts are integers and the sort orders
//     distinct keys, so the result is the same bits on every call,
//     whatever order the atomics gather in.
// The kernels allocate nothing; the caller passes the outputs and the
// workspaces.

#include "ce_online.cuh"

#include <math.h>

namespace {

// ---- (1) f32 logits on the CUDA cores ----

constexpr int kBM = 128;          // rows of h a block
constexpr int kBN = 128;          // vocab rows a tile
constexpr int kBK = 8;            // columns of D a staged chunk
constexpr int kThreads = 256;     // 16 x 16, 8 x 8 products each
constexpr int kStride = kBM + 4;  // a chunk's row stride in shared memory
constexpr float kNeg = -1e30f;    // the TPU kernels' running-max start

// columns [c, c + 4) of row `row` of a row-major (total, d) f32 array, 0
// past its end: one 16-byte load where D is a multiple of 4 (c is, and
// the wrapper's tensors start on 16 bytes)
__device__ __forceinline__ void load4(float (&r)[4],
                                      const float* __restrict__ src,
                                      int total, int d, int row, int c) {
  if ((d & 3) == 0 && row < total && c + 3 < d) {
    const float4 x =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)row * d + c));
    r[0] = x.x;
    r[1] = x.y;
    r[2] = x.z;
    r[3] = x.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = row < total && c + i < d ? __ldg(src + (size_t)row * d + c + i)
                                    : 0.f;
}

// block (row tile of kBM, vocab split): the split's tiles of logits h . W_v
// + b_v into logits (N, V), and each row's (max, sum of exp) over the
// split into part_ms[split] (splits, N, 3; the third value unused). Thread
// (ty, tx) holds rows ty * 4 + i and 64 + ty * 4 + i, columns tx * 4 + j
// and 64 + tx * 4 + j of each tile (i, j < 4).
__global__ void __launch_bounds__(kThreads)
topk_select_logits_f32_kernel(const float* __restrict__ h,
                              const float* __restrict__ w,
                              const float* __restrict__ b,
                              float* __restrict__ logits,
                              float* __restrict__ part_ms, int n, int d,
                              int v, int tiles_per_split) {
  __shared__ __align__(16) float as[2][kBK][kStride];
  __shared__ __align__(16) float bs[2][kBK][kStride];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // the loader's row of the chunk and its 4 columns
  const int lr = threadIdx.x >> 1;
  const int lc = (threadIdx.x & 1) * 4;
  const int row0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int nvt = (v + kBN - 1) / kBN;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, nvt);

  float m[8], s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    s[i] = 0.f;
  }
  for (int t = t0; t < t1; ++t) {
    const int col0 = t * kBN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float ra[4], rb[4];
    load4(ra, h, n, d, row0 + lr, lc);
    load4(rb, w, v, d, col0 + lr, lc);
    __syncthreads();  // the last tile's reads of buffer 0 are done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      as[0][lc + i][lr] = ra[i];
      bs[0][lc + i][lr] = rb[i];
    }
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < d; k0 += kBK) {
      const bool more = k0 + kBK < d;
      if (more) {
        load4(ra, h, n, d, row0 + lr, k0 + kBK + lc);
        load4(rb, w, v, d, col0 + lr, k0 + kBK + lc);
      }
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float* ak = as[buf][kk];
        const float* bk = bs[buf][kk];
        const float4 a0 = *reinterpret_cast<const float4*>(ak + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(ak + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(bk + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(bk + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float c[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
      }
      if (more) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          as[buf ^ 1][lc + i][lr] = ra[i];
          bs[buf ^ 1][lc + i][lr] = rb[i];
        }
        __syncthreads();
        buf ^= 1;
      }
    }
    float bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      bias[j] = c < v ? __ldg(b + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      float cm = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        if (c < v) {
          acc[i][j] += bias[j];
          cm = fmaxf(cm, acc[i][j]);
          if (r < n) logits[(size_t)r * v + c] = acc[i][j];
        }
      }
      const float mn = fmaxf(m[i], cm);
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        if (c < v) se += expf(acc[i][j] - mn);
      }
      s[i] = s[i] * expf(m[i] - mn) + se;
      m[i] = mn;
    }
  }
  // the 16 threads of a row (lanes of one half-warp) merged in a fixed
  // butterfly
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[i], o);
      const float mn = fmaxf(m[i], m2);
      s[i] = s[i] * expf(m[i] - mn) + s2 * expf(m2 - mn);
      m[i] = mn;
    }
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (tx == 0 && r < n) {
      float* out = part_ms + ((size_t)split * n + r) * 3;
      out[0] = m[i];
      out[1] = s[i];
    }
  }
}

// ---- (1) bf16 logits on the tensor cores ----

constexpr int kStages = 2;  // the ring's: two stages of 24 KB
using Ring = ceo::Ring<kStages>;

// block (row tile of 64, vocab split): the wide K3's tiles (bias added,
// -inf past V) into logits (N, V), each row's (max, sum) into part_ms
__global__ void __launch_bounds__(wg::kThreads)
topk_select_logits_mma_kernel(const __grid_constant__ CUtensorMap hmap,
                              const __grid_constant__ CUtensorMap wmap,
                              const float* __restrict__ b,
                              float* __restrict__ logits,
                              float* __restrict__ part_ms, int n, int dp,
                              int v, int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[kStages];
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * wg::kRows;
  const int split = blockIdx.y;
  const int nvt = (v + ceo::kTV - 1) / ceo::kTV;
  const int t0 = split * tiles_per_split;
  const int count = min(t0 + tiles_per_split, nvt) - t0;
  Ring ring;
  ring.begin(&hmap, &wmap, smem_raw, bar, row0, t0, count, dp);
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
  ceo::Softmax sm;
  sm.init(nullptr, row0 + r, n);
  for (int it = 0; it < count; ++it) {
    const int col0 = (t0 + it) * ceo::kTV;
    const int c0 = col0 + 2 * (lane & 3);
    float bias[32];
    ceo::load_bias(bias, b, col0, c0, v);
    float acc[64];
    ring.tile(acc, it);
    sm.add_tile(acc, bias, col0, c0, v);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + r + 8 * hh;
      if (row >= n) continue;
      float* out = logits + (size_t)row * v;
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c0 + 8 * q + e < v) out[c0 + 8 * q + e] = acc[4 * q + 2 * hh + e];
    }
  }
  sm.store(part_ms, split, row0 + r, n, lane);
}

// ---- (2) the select ----

constexpr int kSelThreads = 512;
constexpr int kUnroll = 4;     // logits a thread loads at once in a scan
constexpr int kCand = 4096;    // keys the compacted passes take
constexpr int kStatic = 2048;  // the select's static shared memory, bound

// x's order-preserving bits (-0 as +0), then ~col: a larger key goes first
__device__ __forceinline__ uint64_t key_of(float x, int col) {
  uint32_t u = __float_as_uint(__fadd_rn(x, 0.f));
  u ^= (u & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u;
  return ((uint64_t)u << 32) | (uint32_t)(0xFFFFFFFFu - (uint32_t)col);
}

__device__ __forceinline__ float value_of(uint64_t key) {
  uint32_t u = (uint32_t)(key >> 32);
  u ^= (u & 0x80000000u) ? 0x80000000u : 0xFFFFFFFFu;
  return __uint_as_float(u);
}

__device__ __forceinline__ int index_of(uint64_t key) {
  return (int)(0xFFFFFFFFu - (uint32_t)key);
}

// appends `key` where `take`, by the whole warp: one atomic a warp on the
// shared count, each taking lane's place after the taking lanes before it
__device__ __forceinline__ void append(uint64_t* out, int* count, bool take,
                                       uint64_t key) {
  const unsigned lanes = __ballot_sync(0xffffffffu, take);
  if (lanes == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(lanes) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(lanes));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (take) out[base + __popc(lanes & ((1u << lane) - 1))] = key;
}

// `key` counted by its byte at `shift` where `in`, by the whole warp (a
// warp's equal bytes added at once)
__device__ __forceinline__ void count_byte(int* hist, bool in, uint64_t key,
                                           int shift) {
  const unsigned active = __ballot_sync(0xffffffffu, in);
  if (in) {
    const int byte = (int)((key >> shift) & 0xFF);
    const unsigned peers = __match_any_sync(active, byte);
    if (__ffs(peers) - 1 == (int)(threadIdx.x & 31))
      atomicAdd(&hist[byte], __popc(peers));
  }
}

// fn(key) for the key of every logit of x[0, v) (device memory), by the
// whole block: kUnroll loads a thread in flight, every thread taking the
// same steps (the warp-wide calls inside fn need them); a key past v is
// passed as 0 with `valid` false
template <typename Fn>
__device__ __forceinline__ void scan_row(const float* __restrict__ x, int v,
                                         Fn fn) {
  for (int at = 0; at < v; at += kSelThreads * kUnroll) {
    float val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = at + u * kSelThreads + threadIdx.x;
      val[u] = e < v ? __ldcg(x + e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = at + u * kSelThreads + threadIdx.x;
      fn(e < v ? key_of(val[u], e) : 0, e < v);
    }
  }
}

struct Bound {
  uint64_t prefix, mask;
};

// The bytes that single out the k largest keys of the row's v logits x, by
// the whole block: a byte a pass from the top, each pass counting the keys
// that match the bytes chosen so far by their next byte and picking the
// byte whose keys hold the wanted rank; it stops where every key of that
// byte is wanted. The index's bytes that V - 1 does not reach are the same
// in every key and are skipped. Once the keys that match the bytes so far
// are at most kCand, the next pass also gathers them into `cand` (shared,
// in any order) and the passes after it count those alone. The keys with
// (key & mask) >= prefix are then exactly the k largest. hist: 256 ints,
// pick: 3 ints, ncand: 1 int (shared).
__device__ Bound radix_bound(const float* x, int v, int k, int* hist,
                             int* pick, uint64_t* cand, int* ncand) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint64_t prefix = 0, mask = 0;
  int want = k;      // the k-th key's rank among the keys that match prefix
  int matched = v;   // the keys that match prefix
  bool compact = false;  // the passes count cand alone
  int held = 0;          // the keys in cand
  for (int shift = 56; shift >= 0; shift -= 8) {
    if (shift < 32 && shift > 0 && ((v - 1) >> shift) == 0) continue;
    const bool gather = !compact && matched <= kCand;
    if (gather) held = matched;  // the keys this pass appends
    for (int i = tid; i < 256; i += kSelThreads) hist[i] = 0;
    if (tid == 0) *ncand = 0;
    __syncthreads();  // (the last pass's pick read)
    if (compact) {
      for (int at = 0; at < held; at += kSelThreads) {
        const int e = at + tid;
        const uint64_t key = e < held ? cand[e] : 0;
        count_byte(hist, e < held && (key & mask) == prefix, key, shift);
      }
    } else {
      scan_row(x, v, [&](uint64_t key, bool valid) {
        const bool in = valid && (key & mask) == prefix;
        count_byte(hist, in, key, shift);
        if (gather) append(cand, ncand, in, key);
      });
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds bytes 255 - 8 l down to 248 - 8 l: the keys above
      // each in order of the lanes, then of its bytes
      int c[8], own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - 8 * lane - j];
        own += c[j];
      }
      int incl = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      int above = incl - own;
      if (above < want && want <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above + c[j] >= want) {
            pick[0] = 255 - 8 * lane - j;
            pick[1] = above;
            pick[2] = c[j];
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    compact = compact || gather;
    prefix |= (uint64_t)pick[0] << shift;
    mask |= (uint64_t)0xFF << shift;
    want -= pick[1];
    matched = pick[2];
    if (matched == want) break;  // every key of the byte is wanted
  }
  return {prefix, mask};
}

// One compare-exchange of a bitonic network across a warp, lane l holding
// place l of a group of 32: with its partner lane, the lower place keeps
// the larger key
__device__ __forceinline__ uint64_t exchange(uint64_t x, int partner) {
  const uint64_t y = __shfl_sync(0xffffffffu, x, partner);
  const bool lower = (int)(threadIdx.x & 31) < partner;
  return lower == (x > y) ? x : y;
}

// The steps of the network within each aligned group of 32 places of
// keys[0, p), a warp a group and a lane a place (places past k read as 0,
// below every key, and are not written back): with kFull, every step of
// a sort of the group (blocks of 2 to 32, each a flip, then
// half-cleaners); else the half-cleaners of strides 16 to 1 that end a
// larger block's merge. By the whole block.
template <bool kFull>
__device__ void sort_groups(uint64_t* keys, int k, int p) {
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < p / 32; g += kSelThreads / 32) {
    const int at = g * 32 + lane;
    uint64_t x = at < k ? keys[at] : 0;
    if (kFull) {
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
        x = exchange(x, lane ^ (size - 1));  // the flip
#pragma unroll
        for (int stride = size >> 2; stride > 0; stride >>= 1)
          x = exchange(x, lane ^ stride);
      }
    } else {
#pragma unroll
      for (int stride = 16; stride > 0; stride >>= 1)
        x = exchange(x, lane ^ stride);
    }
    if (at < k) keys[at] = x;
  }
}

// keys[0, k) sorted in descending order by the whole block: a bitonic
// network over the next power of two p >= k (at least 32) in which every
// merge sorts the same way (a flip, then half-cleaners), so the places
// past k hold the smallest keys throughout and their comparators are left
// out. The steps within groups of 32 places run in a warp's registers
// (shuffles), the others in shared memory.
__device__ void sort_desc(uint64_t* keys, int k) {
  int p = 32;
  while (p < k) p <<= 1;
  sort_groups<true>(keys, k, p);
  __syncthreads();
  for (int size = 64; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride >= 32; stride >>= 1) {
      const int lg = __ffs(stride) - 1;  // the sizes are powers of two
      for (int i = threadIdx.x; i < p / 2; i += kSelThreads) {
        const int pos = i & (stride - 1);
        // the flip pairs a place with its mirror in the block of `size`,
        // the half-cleaners with the place `stride` on
        const int a = ((i >> lg) << (lg + 1)) + pos;
        const int bb = stride == size >> 1 ? a + 2 * stride - 1 - 2 * pos
                                           : a + stride;
        if (bb < k) {
          const uint64_t x = keys[a], y = keys[bb];
          if (x < y) {
            keys[a] = y;
            keys[bb] = x;
          }
        }
      }
      __syncthreads();
    }
    sort_groups<false>(keys, k, p);
    __syncthreads();
  }
}

// a block per row: the row's k largest logits (and their indices) in
// descending order, and its logsumexp from the splits' (max, sum) pairs in
// split order. Dynamic shared memory: kCand candidate keys, then the k
// keys when keys_shared (else they go to the caller's scratch row, N x k).
__global__ void __launch_bounds__(kSelThreads)
topk_select_kernel(const float* __restrict__ logits,
                   const float* __restrict__ part_ms,
                   uint64_t* __restrict__ scratch, float* __restrict__ vals,
                   int* __restrict__ idx, float* __restrict__ lse, int n,
                   int v, int k, int splits, int keys_shared) {
  extern __shared__ uint64_t dyn[];
  __shared__ int hist[256];
  __shared__ int pick[3];
  __shared__ int ncand;
  __shared__ int taken;
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  uint64_t* keys = keys_shared ? dyn + kCand : scratch + (size_t)row * k;
  const float* x = logits + (size_t)row * v;
  if (tid == 0) taken = 0;
  // every key is wanted at k = V
  const Bound bd = k == v ? Bound{0, 0}
                          : radix_bound(x, v, k, hist, pick, dyn, &ncand);
  __syncthreads();  // (taken set)
  scan_row(x, v, [&](uint64_t key, bool valid) {
    append(keys, &taken, valid && (key & bd.mask) >= bd.prefix, key);
  });
  __syncthreads();
  sort_desc(keys, k);
  for (int i = tid; i < k; i += kSelThreads) {
    vals[(size_t)row * k + i] = value_of(keys[i]);
    idx[(size_t)row * k + i] = index_of(keys[i]);
  }
  if (tid < 32) {
    // lane l merges splits l, l + 32, ... in order, then the lanes in a
    // fixed butterfly
    float m = kNeg, sum = 0.f;
    for (int sp = tid; sp < splits; sp += 32) {
      const float* p = part_ms + ((size_t)sp * n + row) * 3;
      const float mn = fmaxf(m, p[0]);
      sum = sum * expf(m - mn) + p[1] * expf(p[0] - mn);
      m = mn;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, sum, o);
      const float mn = fmaxf(m, m2);
      sum = sum * expf(m - mn) + s2 * expf(m2 - mn);
      m = mn;
    }
    if (tid == 0) lse[row] = m + logf(sum);
  }
}

// the select's dynamic shared memory: kCand candidate keys, then the row's
// k keys where they fit beside them and the static part
int select_plan(int k, int* keys_shared, size_t* smem) {
  int dev = 0, optin = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  const size_t cand = sizeof(uint64_t) * kCand;
  const size_t keys = sizeof(uint64_t) * (size_t)k;
  *keys_shared = cand + keys + kStatic <= (size_t)optin;
  *smem = cand + (*keys_shared ? keys : 0);
  return 0;
}

int launch_select(const void* logits, const void* part_ms, void* scratch,
                  void* vals, void* idx, void* lse, int n, int v, int k,
                  int splits, cudaStream_t st) {
  int keys_shared = 0;
  size_t smem = 0;
  int err = select_plan(k, &keys_shared, &smem);
  if (!err) err = ceo::set_smem((const void*)topk_select_kernel, smem);
  if (err) return err;
  topk_select_kernel<<<n, kSelThreads, smem, st>>>(
      (const float*)logits, (const float*)part_ms, (uint64_t*)scratch,
      (float*)vals, (int*)idx, (float*)lse, n, v, k, splits, keys_shared);
  return (int)cudaGetLastError();
}

bool bad(int n, int d, int v, int k) {
  return n <= 0 || d <= 0 || v <= 0 || k < 1 || k > v;
}

}  // namespace

extern "C" {

// (rows of h per tile, vocab rows per tile, blocks of the logits kernel per
// SM) into out[3], on the current device: what the wrapper cuts the vocab
// into splits by (the width does not enter).
int deepsc_topk_select_tiling_f32(int d, int* out) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  out[0] = kBM;
  out[1] = kBN;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], topk_select_logits_f32_kernel, kThreads, 0);
}

int deepsc_topk_select_tiling_bf16(int d, int* out) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  return ceo::tiling((const void*)topk_select_logits_mma_kernel,
                     wg::kThreads, Ring::kBytes, wg::kRows, ceo::kTV, out);
}

// h: contiguous f32 (N, D), any D >= 1; w: f32 (V, D); b: f32 (V);
// 1 <= k <= V. Outputs vals f32 (N, k), idx int32 (N, k), lse f32 (N).
// Workspaces: logits f32 (N, V), part_ms f32 (splits, N, 3), scratch
// uint64 (N, k) (used where k keys do not fit a block's shared memory).
// Every split must own at least one vocab tile of 128 rows. Returns
// cudaGetLastError() after the launches (0 = success).
int deepsc_topk_select_f32(const void* h, const void* w, const void* b,
                           void* vals, void* idx, void* lse, void* logits,
                           void* part_ms, void* scratch, int n, int d, int v,
                           int k, int splits, void* stream) {
  const int tps = ceo::split_tiles(n, v, splits, kBN);
  if (bad(n, d, v, k) || tps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  topk_select_logits_f32_kernel<<<dim3((n + kBM - 1) / kBM, splits),
                                  kThreads, 0, st>>>(
      (const float*)h, (const float*)w, (const float*)b, (float*)logits,
      (float*)part_ms, n, d, v, tps);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_select(logits, part_ms, scratch, vals, idx, lse, n, v, k,
                       splits, st);
}

// As deepsc_topk_select_f32 with bf16 h (N, dp) and w (V, dp), zero in the
// columns past D (dp: D rounded up to a multiple of 8, the TMA's 16-byte
// rows), 16-byte aligned; splits own vocab tiles of 128 rows.
int deepsc_topk_select_bf16(const void* h, const void* w, const void* b,
                            void* vals, void* idx, void* lse, void* logits,
                            void* part_ms, void* scratch, int n, int dp,
                            int v, int k, int splits, void* stream) {
  const int tps = ceo::split_tiles(n, v, splits, ceo::kTV);
  if (bad(n, dp, v, k) || dp % 8 != 0 || tps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap hmap, wmap;
  int err = wg::make_map(&hmap, h, n, dp, wg::kRows);
  if (!err) err = wg::make_map(&wmap, w, v, dp, ceo::kTV);
  if (!err)
    err = ceo::set_smem((const void*)topk_select_logits_mma_kernel,
                        Ring::kBytes);
  if (err) return err;
  topk_select_logits_mma_kernel<<<dim3((n + wg::kRows - 1) / wg::kRows,
                                       splits),
                                  wg::kThreads, Ring::kBytes, st>>>(
      hmap, wmap, (const float*)b, (float*)logits, (float*)part_ms, n, dp, v,
      tps);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_select(logits, part_ms, scratch, vals, idx, lse, n, v, k,
                       splits, st);
}

}  // extern "C"
