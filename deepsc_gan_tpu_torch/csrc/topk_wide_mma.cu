// Fused beam-candidate scorer (K6) at any width D and k up to 256, bf16, on
// Hopper's tensor cores (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_topk_kernel` of deepsc_gan_tpu/ops/pallas/
// topk.py where the tuned K6 (csrc/topk.cu: lists of at most 8 in
// registers, D a multiple of 8 up to 256) does not take a bf16 call: k from
// 9 (`--beam-size 9` on the widened decoder, d_model 200) up to kMaxList =
// 64 with a list a row, past it up to kMaxLong = 256 (`--beam-size 100`)
// by the long path below (V up to 25,000), and any D
// (`--decoder-d-model 512`). f32, and bf16 past k = 256 or past V =
// 25,000, take csrc/topk_select.cu. Same function as the tuned kernel: per
// row of h (N, D) over the vocab table W (V, D) and bias b (V) f32, the k
// largest logits h . W_v + b_v in descending order, ties to the lowest vocab
// index, their indices, and the row's logsumexp, with exact products of the
// bf16 operands and f32 sums; the (N, V) logits never reach device memory.
//
// What bounds it: operations. At the wide beam (N = 64 x 9 = 576, D = 200,
// V = 22,234, k = 9) one call does 2 N D V = 5.1 GFLOP (0.0052 ms at the
// bf16 tensor-core rate) and N V = 12.8 M exponentials, and reads 9 MB.
// The design before this one (CUDA-core tiles, the logits through an
// (N, V) f32 workspace and k rounds of a block argmax over it; since
// replaced by csrc/topk_select.cu) took 1.006 ms there on an H100 80GB HBM3 at 700 W, and 5.984
// ms at k = 100, N = 256, D = 200, where `torch.topk` + `logsumexp` take
// 0.216 (the lists of this kernel grown to 128 a row took 0.287, most of
// it in their merges, at one block an SM).
//
// Design. The logits are the wide K3's (csrc/ce_wide_fwd.cu): block (row
// tile of 64, vocab split) walks its vocab tiles of 128 rows with D
// streamed through `ceo::Ring` (wgmma m64n128k16 into one 64 x 128 f32
// tile), and `ceo::Softmax` keeps each row's running (max, sum). Thread t
// holds rows r and r + 8 (r = 16 (t / 32) + lane / 4) at columns 8 q + 2
// (lane % 4) + e of each tile, so the four threads of a quad own a row.
// The selection runs in the tile's epilogue by a threshold filter, without
// a per-logit list insert:
// - each row keeps its k best so far in shared memory, sorted by a 64-bit
//   key (the value's order-preserving bits, then the complement of the
//   index: a larger key goes first, ties to the lower index), and tau, the
//   k-th value (-inf until the list holds k);
// - a logit of the tile is a candidate when it is above tau: the tile's
//   columns lie above every index in the list, so an equal value loses and
//   strict > keeps ties to the lowest index; while the list is not full,
//   a candidate must also reach a value that at least k logits of the
//   tile reach (kBisect halvings of the row's range over the quad), so
//   that none below it can be among the k best;
// - the quad writes its candidates to the row's buffer of kBuf keys (each
//   thread's after those of the threads before it), merges buffer and
//   list in place by rank, and raises tau; candidates
//   past the buffer wait for the next round if their key is still above
//   the list's k-th. Few logits pass once the list is full. The selection
//   reads the tile's logits from a local copy through the candidates' set
//   bits, and its merge is not inlined, so the tile loop's code stays
//   small.
// - the splits of a row share a threshold: a full list's k-th key goes to
//   the row's slot in device memory (an integer atomicMax), every split
//   reads the slot before each tile and filters by the larger of it and
//   its own k-th key. Any split's k-th key is at most the row's k-th, so
//   none of the row's k best is filtered out; which other keys the lists
//   hold depends on the blocks' timing, the k best (the output) do not.
//   At k = 64 over 29 splits it cuts the candidates several fold.
// A quad owns its rows alone, so the selection needs no block barrier.
// Block (row tile, split) writes each row's k keys and (max, sum); a
// second kernel, a block per row, merges the splits: the keys at or above
// the row's threshold, each placed by its rank among them (k rounds of the
// warp's largest head key over the sorted lists where they are too many),
// and the (max, sum) pairs in a fixed order into lse. Past k = 64 the long
// path (described above its kernels) keeps lists of 16 and passes the
// logits twice. No float atomics: the same bits on every call. The splits
// are the wrapper's (`vocab_splits` from this library's tiling). The TMA
// fills columns past D with zeros; a D off 8 columns comes as zero-padded
// copies of width dp. Vocab columns past V (the last tile) are -inf after
// the softmax's epilogue and never pass.

#include "ce_online.cuh"

namespace {

using ceo::kTV;

constexpr int kStages = 2;       // the ring's: two stages of 24 KB
using Ring = ceo::Ring<kStages>;
constexpr int kMaxList = 64;     // the longest list
constexpr int kBuf = 32;         // candidate keys a row takes per round
constexpr int kBisect = 12;      // halvings of the first tile's bound
constexpr int kMergeThreads = 128;     // a merge block's (one row)
constexpr int kMaxSplitsPerThread = 4; // the merge's: 512 splits
constexpr int kMaxCand = 512;          // keys a row's ranked merge takes
constexpr size_t kMergeSmem = 200 * 1024;
// the long path (kMaxList < k <= kMaxLong, V <= kMaxLongV): lists of
// kSelect a split, then the emission of the keys at or above each row's
// bound and a block per row's select of the k best
constexpr int kMaxLong = 256;
constexpr int kSelect = 16;
constexpr int kFinalThreads = 256;
constexpr int kMaxLongV = 25000;

// 8-byte keys of a row's selection state: its list of KL, the buffer, and
// one more so that the rows of a warp's eight quads fall in distinct banks
template <int KL>
__host__ __device__ constexpr int row_keys() {
  return KL + kBuf + 1;
}

template <int KL>
constexpr size_t smem_bytes() {
  return Ring::kBytes + sizeof(uint64_t) * wg::kRows * row_keys<KL>();
}

// the list length that holds k (past kMaxList: the long path's lists)
int list_length(int k) {
  return k <= 16 ? 16 : k <= 32 ? 32 : k <= kMaxList ? kMaxList : kSelect;
}

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

// A value that at least k of the quad's 128 logits of row half h reach
// (its threads' 32 columns of the tile), as high as kBisect halvings of
// their range find it: no logit below it can be among the k best of the
// list and the tile. -inf where fewer than k are finite (a ragged tile).
// Every lane of the warp takes the same steps (the shuffles need them).
__device__ __forceinline__ float tile_bound(const float (&acc)[64], int h,
                                            int k) {
  float v[32];  // the row half's logits, out of the accumulator registers
  float lo = INFINITY, hi = -INFINITY;
  int finite = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    v[i] = acc[4 * (i >> 1) + 2 * h + (i & 1)];
    if (v[i] > -INFINITY) {
      lo = fminf(lo, v[i]);
      ++finite;
    }
    hi = fmaxf(hi, v[i]);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    finite += __shfl_xor_sync(0xffffffffu, finite, o);
  }
#pragma unroll 1
  for (int step = 0; step < kBisect; ++step) {  // count(v >= lo) >= k
    const float mid = lo + 0.5f * (hi - lo);
    int reach = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) reach += v[i] >= mid;
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      reach += __shfl_xor_sync(0xffffffffu, reach, o);
    if (reach >= k)
      lo = mid;
    else
      hi = mid;
  }
  return finite >= k ? lo : -INFINITY;
}

// how many of the first `count` keys of a descending array lie above
// `key`: a binary search of fixed steps (count <= N, a power of two), so
// the searches of a thread's keys run side by side
template <int N>
__device__ __forceinline__ int count_above(const uint64_t* sorted,
                                           int count, uint64_t key) {
  int pos = 0;
#pragma unroll
  for (int step = N; step >= 1; step >>= 1)
    if (pos + step <= count && sorted[pos + step - 1] > key) pos += step;
  return pos;
}

// The row's list (sorted, k entries, 0 for empty) and its buffer's nb keys
// (none in a quad with no candidate) merged in place, by the whole warp,
// each quad on its own row (tq: this thread's place in it). A buffer key's
// place in the merged list is its rank in the buffer (the buffer keys
// above it) plus the list keys above it (a binary search); the list's
// keys, in order, take the places the buffer's leave (a bitmap of the
// taken places, merged over the quad: k <= 64). Every read comes before
// every write. Where the list holds fewer than k, the places past the
// merged keys stay 0. Not inlined: the selection runs seldom, and its code
// stays small beside the tile loop's.
template <int KL>
__device__ __noinline__ void merge(uint64_t* st, int nb, int k, int tq) {
  constexpr int M = kBuf / 4;  // buffer keys a thread takes
  constexpr int F = KL / 4;    // list places a thread fills
  uint64_t* list = st;
  const uint64_t* buf = st + KL;
  uint64_t key[M];
  int at[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    key[m] = tq + 4 * m < nb ? buf[tq + 4 * m] : 0;
    at[m] = 0;
  }
#pragma unroll 4
  for (int i = 0; i < nb; ++i) {
    const uint64_t x = buf[i];
#pragma unroll
    for (int m = 0; m < M; ++m) at[m] += x > key[m];
  }
  unsigned long long taken = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (key[m] == 0) continue;
    at[m] += count_above<KL>(list, k, key[m]);
    if (at[m] < k) taken |= 1ull << at[m];
  }
  taken |= __shfl_xor_sync(0xffffffffu, taken, 1);
  taken |= __shfl_xor_sync(0xffffffffu, taken, 2);
  uint64_t fill[F];
#pragma unroll
  for (int t = 0; t < F; ++t) {
    const int place = tq + 4 * t;
    fill[t] = place < k && !((taken >> place) & 1)
                  ? list[place - __popcll(taken & ((1ull << place) - 1))]
                  : 0;
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < M; ++m)
    if (key[m] != 0 && at[m] < k) list[at[m]] = key[m];
#pragma unroll
  for (int t = 0; t < F; ++t) {
    const int place = tq + 4 * t;
    if (place < k && !((taken >> place) & 1)) list[place] = fill[t];
  }
}

// The tile's candidates of the thread's two rows (mask[h]: bit 2 q + e for
// column c0 + 8 q + e of row half h, the logit x[4 q + 2 h + e]) into the
// rows' lists, in rounds of at most kBuf a row (each thread's after those
// of the quad's threads before it); kth (a list's k-th key, 0 until it
// holds k) follows the lists, and a full list's k-th goes to the
// row's shared threshold `slot` (null for a row past N). Candidates left
// after a round stay while they lie above the raised threshold (the
// larger of kth and `shared`, the slot as read before the tile): above
// its value, or equal to it at a lower index. The merge orders by the
// whole key, so the order in which the candidates are written does not
// matter. x is the tile's logits copied
// to a local array (indexed by the candidates' bits: the loops walk the
// set bits alone). Called by the whole warp.
template <int KL>
__device__ __forceinline__ void take(const float* x, uint32_t (&mask)[2],
                                     uint64_t* const (&st)[2], int c0,
                                     int col0, int k, int lane,
                                     const uint64_t (&shared)[2],
                                     uint64_t (&kth)[2],
                                     unsigned long long* const (&slot)[2]) {
  const int tq = lane & 3;
  while (__any_sync(0xffffffffu, (mask[0] | mask[1]) != 0)) {
    int total[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int own = __popc(mask[h]);
      int incl = own;  // the sum over the quad's threads up to this one
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o, 4);
        if (tq >= o) incl += y;
      }
      total[h] = __shfl_sync(0xffffffffu, incl, 3, 4);
      uint32_t written = 0;
#pragma unroll 1
      for (uint32_t m = mask[h], at = incl - own; m != 0 && at < kBuf;
           m &= m - 1, ++at) {
        const int p = __ffs(m) - 1;  // bit 2 q + e
        st[h][KL + at] =
            key_of(x[4 * (p >> 1) + 2 * h + (p & 1)], c0 + 8 * (p >> 1) +
                                                          (p & 1));
        written |= 1u << p;
      }
      mask[h] &= ~written;
    }
    __syncwarp();  // the buffers written
#pragma unroll
    for (int h = 0; h < 2; ++h)
      merge<KL>(st[h], min(total[h], kBuf), k, tq);
    __syncwarp();  // the merges done: their lists complete, buffers free
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (total[h] == 0) continue;
      kth[h] = st[h][k - 1];
      if (kth[h] != 0 && tq == 0 && slot[h] != nullptr)
        atomicMax(slot[h], kth[h]);
      const uint64_t thr = kth[h] > shared[h] ? kth[h] : shared[h];
      if (thr == 0) continue;
      const float tv = value_of(thr);
      const bool ties = index_of(thr) >= col0;
#pragma unroll 1
      for (uint32_t m = mask[h]; m != 0; m &= m - 1) {
        const int p = __ffs(m) - 1;
        const float v = x[4 * (p >> 1) + 2 * h + (p & 1)];
        if (!(v > tv || (ties && v == tv &&
                         key_of(v, c0 + 8 * (p >> 1) + (p & 1)) > thr)))
          mask[h] &= ~(1u << p);
      }
    }
  }
}

// block (row tile, vocab split): each row's k best keys over the split's
// vocab tiles into part_key (N, splits, k: a row's lists side by side),
// and its (max, sum) into part_ms[split] (splits, N, 3; the third value
// unused)
template <int KL>
__global__ void __launch_bounds__(wg::kThreads)
topk_wide_mma_kernel(const __grid_constant__ CUtensorMap hmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const float* __restrict__ b,
                     uint64_t* __restrict__ part_key,
                     float* __restrict__ part_ms,
                     unsigned long long* __restrict__ row_kth, int n,
                     int dp, int v, int k, int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[kStages];

  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * wg::kRows;
  const int split = blockIdx.y;
  const int nvt = (v + kTV - 1) / kTV;
  const int t0 = split * tiles_per_split;
  const int count = min(t0 + tiles_per_split, nvt) - t0;
  uint64_t* state = reinterpret_cast<uint64_t*>(
      wg::align_1024(smem_raw) + kStages * Ring::kStageBytes);
  for (int i = threadIdx.x; i < wg::kRows * row_keys<KL>(); i += blockDim.x)
    state[i] = 0;
  Ring ring;  // its set-up's barrier also orders the zeroing above
  ring.begin(&hmap, &wmap, smem_raw, bar, row0, t0, count, dp);

  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
  uint64_t* const st[2] = {state + r * row_keys<KL>(),
                           state + (r + 8) * row_keys<KL>()};
  unsigned long long* const slot[2] = {
      row_kth && row0 + r < n ? row_kth + row0 + r : nullptr,
      row_kth && row0 + r + 8 < n ? row_kth + row0 + r + 8 : nullptr};
  uint64_t kth[2] = {0, 0};
  ceo::Softmax sm;
  sm.init(nullptr, row0 + r, n);
  for (int it = 0; it < count; ++it) {
    const int col0 = (t0 + it) * kTV;
    const int c0 = col0 + 2 * (lane & 3);
    float bias[32];
    ceo::load_bias(bias, b, col0, c0, v);
    uint64_t shared[2];  // the rows' thresholds so far, read from L2
#pragma unroll
    for (int h = 0; h < 2; ++h) shared[h] = slot[h] ? __ldcg(slot[h]) : 0;
    float acc[64];
    ring.tile(acc, it);
    sm.add_tile(acc, bias, col0, c0, v);  // acc: the logits, -inf past V
    uint32_t mask[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lo = -INFINITY;  // the bound, while the list is not full
      if (__any_sync(0xffffffffu, kth[h] == 0)) {
        lo = tile_bound(acc, h, k);
        if (kth[h] != 0) lo = -INFINITY;
      }
      // above the threshold key: above its value, or equal to it at a
      // lower index, which this tile's columns hold only where the
      // threshold comes from a later split
      const uint64_t thr = kth[h] > shared[h] ? kth[h] : shared[h];
      const float tv = thr != 0 ? value_of(thr) : -INFINITY;
      const bool ties = thr != 0 && index_of(thr) >= col0;
      mask[h] = 0;
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[4 * q + 2 * h + e];
          if ((x > tv || (ties && x == tv)) && x >= lo)
            mask[h] |= 1u << (2 * q + e);
        }
    }
    if (__any_sync(0xffffffffu, (mask[0] | mask[1]) != 0)) {
      float x[64];  // local: the candidates' bits index it
#pragma unroll
      for (int i = 0; i < 64; ++i) x[i] = acc[i];
      take<KL>(x, mask, st, c0, col0, k, lane, shared, kth, slot);
    }
  }
  sm.store(part_ms, split, row0 + r, n, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    if (row >= n) continue;
    uint64_t* out = part_key + ((size_t)row * gridDim.y + split) * k;
    for (int i = lane & 3; i < k; i += 4) out[i] = st[h][i];
  }
}

// The bytes that single out the k best of `total` keys in shared memory
// (0 for none; at least k nonzero), by the whole block: a radix select of
// the k-th largest key, a byte a pass from the top. Each pass counts the
// keys that match the bytes chosen so far by their next byte (a warp's
// equal bytes added at once) and picks the byte whose keys hold the wanted
// rank; it stops early where every key of that byte is wanted. The keys
// with (key & mask) >= prefix are then exactly the k best (keys are
// unique). The counts are integers, so the same bytes are chosen on every
// call. hist: 256 ints, pick: 3 (shared).
struct Bound {
  uint64_t prefix, mask;
};

__device__ Bound radix_bound(const uint64_t* keys, int total, int k,
                             int* hist, int* pick) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  uint64_t prefix = 0, mask = 0;
  int want = k;  // K*'s rank among the keys that match prefix
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += nt) hist[i] = 0;
    __syncthreads();  // (the keys, and the last pass's pick read)
    for (int at = 0; at < total; at += nt) {
      const int e = at + tid;
      const uint64_t key = e < total ? keys[e] : 0;
      const bool in = key != 0 && (key & mask) == prefix;
      const int byte = (int)((key >> shift) & 0xFF);
      const unsigned active = __ballot_sync(0xffffffffu, in);
      if (in) {
        const unsigned peers = __match_any_sync(active, byte);
        if (__ffs(peers) - 1 == lane) atomicAdd(&hist[byte], __popc(peers));
      }
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
    prefix |= (uint64_t)pick[0] << shift;
    mask |= (uint64_t)0xFF << shift;
    want -= pick[1];
    if (pick[2] == want) break;  // every key of the byte is wanted
  }
  return {prefix, mask};
}

// The k best of `total` keys in shared memory (`radix_bound`), gathered
// into best[k] and each placed by its rank among them: vals and idx of
// `row`, largest first. taken: 1 int (shared).
__device__ void select_top(const uint64_t* keys, int total, int k,
                           uint64_t* best, int* hist, int* pick, int* taken,
                           float* __restrict__ vals, int* __restrict__ idx,
                           int row) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (tid == 0) *taken = 0;
  const Bound bd = radix_bound(keys, total, k, hist, pick);
  for (int at = 0; at < total; at += nt) {
    const int e = at + tid;
    const uint64_t key = e < total ? keys[e] : 0;
    if (key != 0 && (key & bd.mask) >= bd.prefix)
      best[atomicAdd(taken, 1)] = key;
  }
  __syncthreads();
  for (int c = tid; c < k; c += nt) {
    const uint64_t key = best[c];
    int rank = 0;
    for (int i = 0; i < k; ++i) rank += best[i] > key;
    vals[(size_t)row * k + rank] = value_of(key);
    idx[(size_t)row * k + rank] = index_of(key);
  }
}

// lse of `row` from the splits' (max, sum) pairs (splits, N, 3), by the
// first warp: lane l merges splits l, l + 32, ... in order, then the lanes
// merge in a fixed butterfly
__device__ void merge_lse(const float* __restrict__ part_ms,
                          float* __restrict__ lse, int n, int splits,
                          int row) {
  const int lane = threadIdx.x & 31;
  float m = ce::NEG, sum = 0.f;
  for (int sp = lane; sp < splits; sp += 32) {
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
  if (lane == 0) lse[row] = m + logf(sum);
}

// a block per row: the splits' sorted lists (staged in shared memory) and
// the row's shared threshold (the largest k-th key a split published, at
// most the row's k-th key: the keys at or above it hold the row's k best)
// give the row's k best. Where at most kMaxCand keys reach the threshold,
// they are gathered and each placed by its rank among them; otherwise
// (or where no split filled its list) k rounds of the block's largest
// head key over the lists. The first warp merges the (max, sum) pairs into
// lse in a fixed order.
__global__ void __launch_bounds__(kMergeThreads)
topk_wide_mma_merge_kernel(const uint64_t* __restrict__ part_key,
                           const float* __restrict__ part_ms,
                           const unsigned long long* __restrict__ row_kth,
                           float* __restrict__ vals, int* __restrict__ idx,
                           float* __restrict__ lse, int n, int k,
                           int splits) {
  extern __shared__ uint64_t keys[];  // the splits' lists, the candidates
  __shared__ int warp_sum[kMergeThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = blockIdx.x;
  uint64_t* cand = keys + splits * k;
  const uint64_t* lists = part_key + (size_t)row * splits * k;
#pragma unroll 4
  for (int e = tid; e < splits * k; e += kMergeThreads) keys[e] = lists[e];
  __syncthreads();
  // the keys of list sp at or above thr: a prefix of the sorted list
  const uint64_t thr = row_kth[row];
  const auto reach = [&](int sp) {
    const uint64_t* list = keys + sp * k;
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (list[mid] >= thr)
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo;
  };
  int own = 0;
  if (thr != 0)
    for (int sp = tid; sp < splits; sp += kMergeThreads) own += reach(sp);
  int incl = own;  // the sum over the block's threads up to this one
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[tid >> 5] = incl;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) {
    if (w < (tid >> 5)) incl += warp_sum[w];
    total += warp_sum[w];
  }
  if (thr != 0 && total <= kMaxCand) {
    int at = incl - own;
    for (int sp = tid; sp < splits; sp += kMergeThreads)
      for (int i = 0, m = reach(sp); i < m; ++i) cand[at++] = keys[sp * k + i];
    __syncthreads();
    for (int c = tid; c < total; c += kMergeThreads) {
      const uint64_t key = cand[c];
      int rank = 0;
      for (int i = 0; i < total; ++i) rank += cand[i] > key;
      if (rank < k) {
        vals[(size_t)row * k + rank] = value_of(key);
        idx[(size_t)row * k + rank] = index_of(key);
      }
    }
  } else {
    // k rounds of the block's largest head key: thread t holds the heads
    // of splits t, t + 128, ...
    __shared__ uint64_t best[2][kMergeThreads / 32];
    int head[kMaxSplitsPerThread];
    uint64_t top[kMaxSplitsPerThread];
#pragma unroll
    for (int u = 0; u < kMaxSplitsPerThread; ++u) {
      const int sp = tid + kMergeThreads * u;
      head[u] = 0;
      top[u] = sp < splits ? keys[sp * k] : 0;
    }
    for (int round = 0; round < k; ++round) {
      uint64_t mine = 0;
      int mu = 0;
#pragma unroll
      for (int u = 0; u < kMaxSplitsPerThread; ++u)
        if (top[u] > mine) {
          mine = top[u];
          mu = u;
        }
      uint64_t w = mine;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const uint64_t x = __shfl_xor_sync(0xffffffffu, w, o);
        w = x > w ? x : w;
      }
      if (lane == 0) best[round & 1][tid >> 5] = w;
      __syncthreads();  // (the slots of round - 1 were read before it)
#pragma unroll
      for (int x = 0; x < kMergeThreads / 32; ++x)
        w = best[round & 1][x] > w ? best[round & 1][x] : w;
      if (w != 0 && mine == w) {  // keys are unique: one thread advances
#pragma unroll
        for (int u = 0; u < kMaxSplitsPerThread; ++u)
          if (u == mu) {
            ++head[u];
            top[u] = head[u] < k
                         ? keys[(tid + kMergeThreads * u) * k + head[u]]
                         : 0;
          }
      }
      if (tid == 0) {
        vals[(size_t)row * k + round] = w != 0 ? value_of(w) : ce::NEG;
        idx[(size_t)row * k + round] = w != 0 ? index_of(w) : (1 << 30);
      }
    }
  }
  if (tid < 32) merge_lse(part_ms, lse, n, splits, row);
}

// ---- the long path, kMaxList < k <= kMaxLong
//
// The lists of kMaxList give way past it: a split's list of k (or a
// buffer's rounds) costs more than the logits. Instead: (1) the partial
// kernel with lists of kSelect and no shared threshold (each split's own
// kSelect best: their union holds at least k keys, the splits being at
// least k / 8), (2) a block per row radix-selects the k-th largest key of
// that union, a lower bound of the row's k-th: the bytes chosen so far
// (prefix, mask) go to row_thr, (3) the logits again (the same tile and
// bias add, so the same bits), each key at or above the row's bound
// appended to the row's candidates (an integer atomicAdd on its count; cap
// slots, the count going on past them), (4) a block per row selects the k
// best of its candidates; (5) a row whose candidates overflowed (many
// equal logits) is done by the fallback: its V logits on the CUDA cores
// into shared memory and the same select. The candidates' order depends on
// the blocks' timing; the select's result does not.

// (2): row_thr[row] = (prefix, mask) of the union's k best; the row's
// candidate count zeroed (and the overflow count by row 0); lse
__global__ void __launch_bounds__(kMergeThreads)
topk_long_threshold_kernel(const uint64_t* __restrict__ part_key,
                           const float* __restrict__ part_ms,
                           unsigned long long* __restrict__ row_thr,
                           int* __restrict__ count, float* __restrict__ lse,
                           int n, int k, int splits) {
  extern __shared__ uint64_t keys[];  // the splits' lists
  __shared__ int hist[256];
  __shared__ int pick[3];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int total = splits * kSelect;
  const uint64_t* lists = part_key + (size_t)row * total;
#pragma unroll 4
  for (int e = tid; e < total; e += kMergeThreads) keys[e] = lists[e];
  const Bound bd = radix_bound(keys, total, k, hist, pick);
  if (tid == 0) {
    row_thr[2 * row] = bd.prefix;
    row_thr[2 * row + 1] = bd.mask;
    count[row] = 0;
    if (row == 0) count[n] = 0;
  }
  if (tid < 32) merge_lse(part_ms, lse, n, splits, row);
}

// (3): block (row tile, vocab split) computes its tiles' logits as the
// partial kernel does and appends each key at or above its row's bound
// to the row's candidates
__global__ void __launch_bounds__(wg::kThreads)
topk_long_emit_kernel(const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ b,
                      const unsigned long long* __restrict__ row_thr,
                      uint64_t* __restrict__ cand, int* __restrict__ count,
                      int n, int dp, int v, int cap, int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[kStages];
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * wg::kRows;
  const int split = blockIdx.y;
  const int nvt = (v + kTV - 1) / kTV;
  const int t0 = split * tiles_per_split;
  const int ntiles = min(t0 + tiles_per_split, nvt) - t0;
  Ring ring;
  ring.begin(&hmap, &wmap, smem_raw, bar, row0, t0, ntiles, dp);
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
  uint64_t prefix[2], mask[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    live[h] = row < n;
    prefix[h] = live[h] ? row_thr[2 * row] : 0;
    mask[h] = live[h] ? row_thr[2 * row + 1] : 0;
  }
  for (int it = 0; it < ntiles; ++it) {
    const int col0 = (t0 + it) * kTV;
    const int c0 = col0 + 2 * (lane & 3);
    float bias[32];
    ceo::load_bias(bias, b, col0, c0, v);
    float acc[64];
    ring.tile(acc, it);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * q + e;
          if (col >= v || !live[h]) continue;
          // the partial kernel's value: the product plus the bias, once
          const float x = acc[4 * q + 2 * h + e] + bias[2 * q + e];
          const uint64_t key = key_of(x, col);
          if ((key & mask[h]) >= prefix[h]) {
            const int row = row0 + r + 8 * h;
            const int at = atomicAdd(&count[row], 1);
            if (at < cap) cand[(size_t)row * cap + at] = key;
          }
        }
  }
}

// (4): a block per row: the k best of its candidates; a row whose
// candidates overflowed goes on the fallback's list (count[n] long)
__global__ void __launch_bounds__(kFinalThreads)
topk_long_final_kernel(const uint64_t* __restrict__ cand,
                       int* __restrict__ count, int* __restrict__ over,
                       float* __restrict__ vals, int* __restrict__ idx,
                       int n, int k, int cap) {
  extern __shared__ uint64_t keys[];  // the candidates, then the k best
  __shared__ int hist[256];
  __shared__ int pick[3];
  __shared__ int taken;
  const int row = blockIdx.x;
  const int total = count[row];
  if (total > cap) {
    if (threadIdx.x == 0) over[atomicAdd(&count[n], 1)] = row;
    return;
  }
  const uint64_t* c = cand + (size_t)row * cap;
  for (int e = threadIdx.x; e < total; e += kFinalThreads) keys[e] = c[e];
  select_top(keys, total, k, keys + total, hist, pick, &taken, vals, idx,
             row);
}

// (5): each block takes rows of the overflow list in turn: the row's V
// logits (h's row and W's rows as f32 products of the bf16 operands,
// summed in order, plus the bias) as keys in shared memory, and their k
// best
__global__ void __launch_bounds__(kFinalThreads)
topk_long_fallback_kernel(const __nv_bfloat16* __restrict__ h,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ b,
                          const int* __restrict__ count,
                          const int* __restrict__ over,
                          float* __restrict__ vals, int* __restrict__ idx,
                          int n, int dp, int v, int k) {
  extern __shared__ uint64_t keys[];  // v keys, the k best, h's row (f32)
  __shared__ int hist[256];
  __shared__ int pick[3];
  __shared__ int taken;
  float* hrow = reinterpret_cast<float*>(keys + v + k);
  const int rows = count[n];
  for (int i = blockIdx.x; i < rows; i += gridDim.x) {
    const int row = over[i];
    __syncthreads();  // (the last row's keys read)
    for (int d = threadIdx.x; d < dp; d += kFinalThreads)
      hrow[d] = __bfloat162float(h[(size_t)row * dp + d]);
    __syncthreads();
    for (int col = threadIdx.x; col < v; col += kFinalThreads) {
      const __nv_bfloat16* wr = w + (size_t)col * dp;
      float x = 0.f;
      for (int d = 0; d < dp; ++d)
        x = fmaf(hrow[d], __bfloat162float(wr[d]), x);
      keys[col] = key_of(x + b[col], col);
    }
    select_top(keys, v, k, keys + v, hist, pick, &taken, vals, idx, row);
  }
}

bool takes(int dp, int k) {
  return dp > 0 && dp % 8 == 0 && k >= 1 && k <= kMaxList;
}

// a merge block's shared memory: the splits' lists and the candidates
size_t merge_smem(int splits, int k) {
  return sizeof(uint64_t) * ((size_t)splits * k + kMaxCand);
}

template <int KL>
int launch(const void* h, const void* w, const void* b, void* vals,
           void* idx, void* lse, void* part_key, void* part_ms,
           void* row_kth, int n, int dp, int v, int k, int splits,
           cudaStream_t st) {
  const int tps = ceo::split_tiles(n, v, splits, kTV);
  const size_t msmem = merge_smem(splits, k);
  if (tps < 0 || k > v || splits > kMergeThreads * kMaxSplitsPerThread ||
      msmem > kMergeSmem)
    return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, wmap;
  int err = wg::make_map(&hmap, h, n, dp, wg::kRows);
  if (!err) err = wg::make_map(&wmap, w, v, dp, kTV);
  if (err) return err;
  const size_t smem = smem_bytes<KL>();
  err = ceo::set_smem((const void*)topk_wide_mma_kernel<KL>, smem);
  if (!err)
    err = ceo::set_smem((const void*)topk_wide_mma_merge_kernel, msmem);
  if (err) return err;
  topk_wide_mma_kernel<KL><<<dim3((n + wg::kRows - 1) / wg::kRows, splits),
                             wg::kThreads, smem, st>>>(
      hmap, wmap, (const float*)b, (uint64_t*)part_key, (float*)part_ms,
      (unsigned long long*)row_kth, n, dp, v, k, tps);
  err = (int)cudaGetLastError();
  if (err) return err;
  topk_wide_mma_merge_kernel<<<n, kMergeThreads, msmem, st>>>(
      (const uint64_t*)part_key, (const float*)part_ms,
      (const unsigned long long*)row_kth, (float*)vals, (int*)idx,
      (float*)lse, n, k, splits);
  return (int)cudaGetLastError();
}

template <int KL>
int tiling(int* out) {
  return ceo::tiling((const void*)topk_wide_mma_kernel<KL>, wg::kThreads,
                     smem_bytes<KL>(), wg::kRows, kTV, out);
}

bool takes_long(int dp, int k, int v) {
  return dp > 0 && dp % 8 == 0 && k > kMaxList && k <= kMaxLong &&
         k <= v && v <= kMaxLongV;
}

// shared memory of the long path's blocks: the threshold's (the splits'
// lists of kSelect), the final select's (cap candidates and the k best),
// the fallback's (the row's v keys, the k best and h's row as f32)
size_t threshold_smem(int splits) {
  return sizeof(uint64_t) * (size_t)splits * kSelect;
}
size_t final_smem(int cap, int k) {
  return sizeof(uint64_t) * ((size_t)cap + k);
}
size_t fallback_smem(int v, int k, int dp) {
  return sizeof(uint64_t) * ((size_t)v + k) + sizeof(float) * dp;
}

int launch_long(const void* h, const void* w, const void* b, void* vals,
                void* idx, void* lse, void* part_key, void* part_ms,
                void* row_thr, void* cand, void* count, void* over, int n,
                int dp, int v, int k, int splits, int emit_splits, int cap,
                cudaStream_t st) {
  const int tps = ceo::split_tiles(n, v, splits, kTV);
  const int etps = ceo::split_tiles(n, v, emit_splits, kTV);
  const size_t tsmem = threshold_smem(splits);
  const size_t fsmem = final_smem(cap, k);
  const size_t bsmem = fallback_smem(v, k, dp);
  // the union of the splits' lists holds at least k keys: every split but
  // the last (whose last tile may be ragged) fills its kSelect
  if (tps < 0 || etps < 0 || (splits - 1) * kSelect < k ||
      tsmem > kMergeSmem || cap < k || fsmem > kMergeSmem)
    return (int)cudaErrorInvalidValue;
  int sms = 0, dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  CUtensorMap hmap, wmap;
  err = wg::make_map(&hmap, h, n, dp, wg::kRows);
  if (!err) err = wg::make_map(&wmap, w, v, dp, kTV);
  if (!err)
    err = ceo::set_smem((const void*)topk_wide_mma_kernel<kSelect>,
                        smem_bytes<kSelect>());
  if (!err)
    err = ceo::set_smem((const void*)topk_long_threshold_kernel, tsmem);
  if (!err)
    err = ceo::set_smem((const void*)topk_long_emit_kernel, Ring::kBytes);
  if (!err) err = ceo::set_smem((const void*)topk_long_final_kernel, fsmem);
  if (!err)
    err = ceo::set_smem((const void*)topk_long_fallback_kernel, bsmem);
  if (err) return err;
  const int tiles = (n + wg::kRows - 1) / wg::kRows;
  topk_wide_mma_kernel<kSelect><<<dim3(tiles, splits), wg::kThreads,
                                  smem_bytes<kSelect>(), st>>>(
      hmap, wmap, (const float*)b, (uint64_t*)part_key, (float*)part_ms,
      nullptr, n, dp, v, kSelect, tps);
  err = (int)cudaGetLastError();
  if (err) return err;
  topk_long_threshold_kernel<<<n, kMergeThreads, tsmem, st>>>(
      (const uint64_t*)part_key, (const float*)part_ms,
      (unsigned long long*)row_thr, (int*)count, (float*)lse, n, k, splits);
  err = (int)cudaGetLastError();
  if (err) return err;
  topk_long_emit_kernel<<<dim3(tiles, emit_splits), wg::kThreads,
                          Ring::kBytes, st>>>(
      hmap, wmap, (const float*)b, (const unsigned long long*)row_thr,
      (uint64_t*)cand, (int*)count, n, dp, v, cap, etps);
  err = (int)cudaGetLastError();
  if (err) return err;
  topk_long_final_kernel<<<n, kFinalThreads, fsmem, st>>>(
      (const uint64_t*)cand, (int*)count, (int*)over, (float*)vals,
      (int*)idx, n, k, cap);
  err = (int)cudaGetLastError();
  if (err) return err;
  topk_long_fallback_kernel<<<n < sms ? n : sms, kFinalThreads, bsmem, st>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)b,
      (const int*)count, (const int*)over, (float*)vals, (int*)idx, n, dp, v,
      k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// How the library takes k, into out[3]: the list length (16, 32 or 64;
// past 64 the long path's lists of 16), the ring's stages, and a block's
// dynamic shared memory in bytes. Returns 0, or cudaErrorInvalidValue
// outside 1 <= k <= 256.
int deepsc_topk_wide_mma_plan(int k, int* out) {
  if (!takes(8, k) && !takes_long(8, k, kMaxLongV))
    return (int)cudaErrorInvalidValue;
  const int kl = list_length(k);
  out[0] = kl;
  out[1] = kStages;
  out[2] = (int)(kl == 16   ? smem_bytes<16>()
                 : kl == 32 ? smem_bytes<32>()
                            : smem_bytes<kMaxList>());
  return 0;
}

// (rows of h per tile, vocab rows per tile, blocks of the partial kernel
// per SM from CUDA's occupancy calculator) into out[3] for k (the width
// does not enter): what the wrapper cuts the vocab into splits by.
int deepsc_topk_wide_mma_tiling_bf16(int k, int* out) {
  if (!takes(8, k) && !takes_long(8, k, kMaxLongV))
    return (int)cudaErrorInvalidValue;
  const int kl = list_length(k);
  return kl == 16 ? tiling<16>(out)
         : kl == 32 ? tiling<32>(out)
                    : tiling<kMaxList>(out);
}

// The emission kernel of the long path, into out[3]: rows of h and of W
// per tile and its blocks an SM (CUDA's occupancy calculator).
int deepsc_topk_wide_mma_emit_tiling_bf16(int* out) {
  return ceo::tiling((const void*)topk_long_emit_kernel, wg::kThreads,
                     Ring::kBytes, wg::kRows, kTV, out);
}

// h: contiguous bf16 (N, dp) and w: bf16 (V, dp), zero in the columns past
// D (dp: D rounded up to a multiple of 8, the TMA's 16-byte rows), 16-byte
// aligned; b: f32 (V); 1 <= k <= min(64, V). Outputs vals f32 (N, k), idx
// int32 (N, k), lse f32 (N). Workspaces: part_key uint64 (N, splits, k),
// part_ms f32 (splits, N, 3), row_kth uint64 (N) set to zero. Every split
// must own at least one vocab tile of 128 rows; at most 512 splits, whose
// k keys a row and kMaxCand more stage within 200 KB. Returns
// cudaGetLastError() after the launches (0 = success).
int deepsc_topk_wide_mma_bf16(const void* h, const void* w, const void* b,
                              void* vals, void* idx, void* lse,
                              void* part_key, void* part_ms, void* row_kth,
                              int n, int dp, int v, int k, int splits,
                              void* stream) {
  if (!takes(dp, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kl = list_length(k);
  if (kl == 16)
    return launch<16>(h, w, b, vals, idx, lse, part_key, part_ms, row_kth, n,
                      dp, v, k, splits, st);
  if (kl == 32)
    return launch<32>(h, w, b, vals, idx, lse, part_key, part_ms, row_kth, n,
                      dp, v, k, splits, st);
  return launch<kMaxList>(h, w, b, vals, idx, lse, part_key, part_ms,
                          row_kth, n, dp, v, k, splits, st);
}

// The long path, kMaxList < k <= 256 (V <= 25,000): h, w, b, the outputs
// and D as deepsc_topk_wide_mma_bf16's. Workspaces: part_key uint64 (N,
// splits, 16), part_ms f32 (splits, N, 3), row_thr uint64 (N, 2), cand
// uint64 (N, cap), count int32 (N + 1), over int32 (N). splits: the
// partial kernel's vocab splits, each owning a vocab tile, with
// (splits - 1) x 16 >= k; emit_splits: the emission's; k <= cap, and
// (cap + k) keys within 200 KB. Returns cudaGetLastError() after the
// launches (0 = success).
int deepsc_topk_wide_mma_long_bf16(const void* h, const void* w,
                                   const void* b, void* vals, void* idx,
                                   void* lse, void* part_key, void* part_ms,
                                   void* row_thr, void* cand, void* count,
                                   void* over, int n, int dp, int v, int k,
                                   int splits, int emit_splits, int cap,
                                   void* stream) {
  if (n <= 0 || !takes_long(dp, k, v)) return (int)cudaErrorInvalidValue;
  return launch_long(h, w, b, vals, idx, lse, part_key, part_ms, row_thr,
                     cand, count, over, n, dp, v, k, splits, emit_splits, cap,
                     (cudaStream_t)stream);
}

}  // extern "C"
