// Star-Transformer satellite update at any width D and any number of heads
// that divides it, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_satellite_kernel` of deepsc_gan_tpu/ops/pallas/
// star.py where the tuned kernel (csrc/star_satellite.cu: a warp per row,
// each lane holding D / 32 consecutive elements, so D in {64, 128, 256} and
// a head spanning a power of two of lanes) does not take the width: the JAX
// kernel takes any D and head count the star model takes, so
// `--encoder-d-model 96` or 512 runs here. Same function and roundings as
// the tuned kernel: row (b, i) attends over its five contexts {h_{i+1},
// h_i, h_{i-1}, e_i, s} (neighbours circular over L), per head
//     s_j = (q_h . k_{j,h}) / sqrt(Dh),  w = softmax_j(s),
//     out_h = sum_j w_j v_{j,h}
// in f32 (the max and sum over the five in that order), rounded once to the
// output type, reading the ring unstacked: q, kh, vh, ke, ve (B, L, D) and
// ks, vs (B, D).
//
// What bounds it: memory, as the tuned kernel's: a row reads q, kh, vh, ke,
// ve and writes its output (6 N D elements a call, and ks, vs, 2 B D),
// against about 20 D flops. At the widened star train step (B = 64, L = 31,
// D = 96, bf16) 2.3 MB, 0.7 us at 3.35 TB/s; at D = 512 in f32 24.4 MB,
// 7.3 us. The design before this one, a warp per (row, head) reading each
// element by a load of its own, left 20 of 32 lanes idle at D = 96 in 8
// heads (Dh = 12) and ran five 5-step butterflies a head: 0.0154 ms at
// D = 96 on an H100 80GB HBM3 at 700 W, 22 x its bound.
//
// Design, the tuned kernel's lessons at any width (`wide_plan` below, which
// ops/star_kernel.py mirrors):
// - rows (`star_group_kernel`): a group of G lanes per row, consecutive
//   rows on consecutive groups (32 / G groups a warp, consecutive warps),
//   so each h row comes once from HBM and its neighbours' reads hit L1/L2.
//   A row is cut into NC chunks of CB bytes, CB the largest of 16, 8, 4 (2
//   in bf16) dividing its bytes, so 16-byte loads wherever the row's bytes
//   allow; lane g holds C consecutive chunks (C in 1, 2, 4, the fewest with
//   NC <= 32 C; G = ceil(NC / C)), E = C CB / size elements, and E is at
//   most Dh, so a lane's elements span at most two heads. q's and the
//   five k rows' chunks are all loaded before any use, the five v rows'
//   after the scores (all eleven at once held 176 registers of loads a
//   lane at D = 512 in f32, spilled, and took 28 % longer there and 3-4 %
//   at D = 96 on an H100: scripts/kernel_variants.py); bf16 stays packed
//   in registers until its product. No shared memory and no barrier (the
//   tuned kernel measured a shared tile behind a barrier slower). The
//   per-head dot products are per-lane partials (an fmaf chain over the
//   lane's elements of each of its heads, in element order), then a
//   segmented shuffle reduction: the partials of the lanes inside a head
//   are summed by a segmented suffix scan (offsets 1, 2, 4, ..., each lane
//   adding its neighbour's sum while the head runs on), the head's total
//   forms at the lane where it starts (its part plus the scan of the lanes
//   after it) and every other lane of the head takes it from there, so
//   heads that straddle lanes (Dh = 12 at 8 bf16 a lane, Dh = 25 at 4 f32)
//   need no alignment, and every lane of a head has the same bits. Then
//   the softmax of each of the lane's (at most two) heads and the weighted
//   sum in f32 registers, one vector store a chunk.
// - heads (`star_head_kernel`), where a row does not fit 32 lanes of 4
//   chunks with E at most Dh (f32 past D = 512, bf16 past 1,024, or heads
//   narrower than a chunk's elements): a warp per (row, head) walks the
//   head's chunks (CB the largest dividing the head's bytes), 32 a pass, the
//   partials summed by a butterfly, then the weighted sum chunk by chunk.
// Every sum in a fixed order: the same bits on every call. The kernels
// allocate nothing; the caller passes the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kContexts = 5;
constexpr int kWarps = 8;  // a block
constexpr int kMaxChunks = 4;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int BYTES>
struct Chunk;
template <>
struct Chunk<2> { using type = unsigned short; };
template <>
struct Chunk<4> { using type = unsigned int; };
template <>
struct Chunk<8> { using type = uint2; };
template <>
struct Chunk<16> { using type = uint4; };

// a chunk of CB bytes: KV elements of T, loaded and stored whole
template <typename T, int CB>
struct Vec {
  static constexpr int KV = CB / (int)sizeof(T);
  using V = typename Chunk<CB>::type;
  static __device__ __forceinline__ V load(const T* src) {
    return __ldg(reinterpret_cast<const V*>(src));
  }
  static __device__ __forceinline__ float at(const V& x, int t) {
    return to_f(reinterpret_cast<const T*>(&x)[t]);
  }
  static __device__ __forceinline__ void store(T* dst, const float* src) {
    V u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int t = 0; t < KV; ++t) e[t] = from_f<T>(src[t]);
    *reinterpret_cast<V*>(dst) = u;
  }
};

// the softmax of the five scores s in place: max and sum in context order,
// each weight by an IEEE division (the tuned kernel's order)
__device__ __forceinline__ void softmax5(float (&s)[kContexts]) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kContexts; ++j) m = fmaxf(m, s[j]);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kContexts; ++j) {
    s[j] = expf(s[j] - m);
    sum += s[j];
  }
#pragma unroll
  for (int j = 0; j < kContexts; ++j) s[j] = __fdiv_rn(s[j], sum);
}

// The ring's rows of row (b, i): the five contexts' k and v rows in the
// TPU kernel's order h_{i+1}, h_i, h_{i-1}, e_i, s (neighbours circular
// over L), and q's.
template <typename T>
struct Rows {
  const T* q;
  const T* k[kContexts];
  const T* v[kContexts];
  T* out;
  __device__ __forceinline__ Rows(const T* q_, const T* kh, const T* vh,
                                  const T* ke, const T* ve, const T* ks,
                                  const T* vs, T* out_, int row, int len,
                                  long long d, long long col) {
    const int b = row / len;  // 32-bit: N is at most 2^30
    const int i = row - b * len;
    const int nxt = b * len + (i + 1 == len ? 0 : i + 1);
    const int prv = b * len + (i == 0 ? len - 1 : i - 1);
    q = q_ + row * d + col;
    k[0] = kh + nxt * d + col;
    k[1] = kh + row * d + col;
    k[2] = kh + prv * d + col;
    k[3] = ke + row * d + col;
    k[4] = ks + b * d + col;
    v[0] = vh + nxt * d + col;
    v[1] = vh + row * d + col;
    v[2] = vh + prv * d + col;
    v[3] = ve + row * d + col;
    v[4] = vs + b * d + col;
    out = out_ + row * d + col;
  }
};

// Rows: a group of g_lanes lanes per row, each lane C chunks of CB bytes
// (E elements, E <= dh). `span`: the most lanes a head touches, so the
// scan's offsets stop below it.
template <typename T, int CB, int C>
__global__ void __launch_bounds__(kWarps * 32)
star_group_kernel(const T* __restrict__ q, const T* __restrict__ kh,
                  const T* __restrict__ vh, const T* __restrict__ ke,
                  const T* __restrict__ ve, const T* __restrict__ ks,
                  const T* __restrict__ vs, T* __restrict__ out, int n,
                  int len, int d, int dh, int g_lanes, int span,
                  float sqrt_dh) {
  using W = Vec<T, CB>;
  constexpr int KV = W::KV;
  constexpr int E = C * KV;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / g_lanes;  // a warp's rows
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp * groups >= n) return;  // the whole warp
  const int slot = lane / g_lanes;
  const int g = lane - slot * g_lanes;  // the lane within its row's group
  const int base = lane - g;
  const int want = warp * groups + slot;
  // lanes past the warp's groups and groups past the rows take part in the
  // shuffles with no chunk of their own
  const bool live = slot < groups && want < n;
  const int row = live ? want : 0;
  const int nc = d / KV;                    // the row's chunks
  const int mine = live ? min(C, nc - g * C) : 0;  // this lane's
  const int a = g * E;                      // its first element
  const Rows<T> r(q, kh, vh, ke, ve, ks, vs, out, row, len, d, a);

  // q's and the five k rows' loads in flight before any use
  typename W::V qr[C], kr[kContexts][C], vr[kContexts][C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c < mine) qr[c] = W::load(r.q + c * KV);
#pragma unroll
  for (int j = 0; j < kContexts; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < mine) kr[j][c] = W::load(r.k[j] + c * KV);

  // the lane's heads: hf from element a, hl the last (hf or hf + 1); the
  // next head starts at element `bound`
  const int hf = a / dh;
  const int bound = (hf + 1) * dh;
  const bool two = a + mine * KV > bound;
  const int hl = two ? hf + 1 : hf;
  // the last head runs on into the next lane; with one head only, the
  // lane is inside it (its part is all the lane holds)
  const bool link = live && g + 1 < g_lanes && mine == C &&
                    a + E < (hl + 1) * dh;
  const bool inside = link && !two;
  // the scan's steps: step t adds the neighbour at offset 2^t while every
  // lane of this lane's window is inside the head
  unsigned take = 0;
  {
    int on = inside;
    int t = 0;
    for (int o = 1; o < span; o <<= 1, ++t) {
      if (on) take |= 1u << t;
      on &= __shfl_down_sync(kAll, on, o);
    }
  }
  // where the lane's first head starts: a lane before it holds the total
  const int gs = hf * dh / E;
  const int from = gs == g ? lane : base + gs;

  float wf[kContexts], wl[kContexts];  // the lane's two heads' weights
#pragma unroll
  for (int j = 0; j < kContexts; ++j) {
    // the lane's parts of its heads, in element order
    float pf = 0.f, pl = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c >= mine) continue;
#pragma unroll
      for (int t = 0; t < KV; ++t) {
        const float p = W::at(qr[c], t);
        const float kv = W::at(kr[j][c], t);
        if (a + c * KV + t < bound)
          pf = fmaf(p, kv, pf);
        else
          pl = fmaf(p, kv, pl);
      }
    }
    // the segmented suffix scan of the first parts over the lanes inside
    // the head; then the head's total at the lane where it starts
    float u = pf;
    {
      int t = 0;
      for (int o = 1; o < span; o <<= 1, ++t) {
        const float x = __shfl_down_sync(kAll, u, o);
        if (take >> t & 1) u += x;
      }
    }
    const float after = __shfl_down_sync(kAll, u, 1);
    const float own = two ? pl : pf;
    const float total = link ? own + after : own;
    const float got = __shfl_sync(kAll, total, from);
    // the first head: complete here if it starts and ends in this lane
    const float tf = gs != g ? got : two ? pf : total;
    wf[j] = __fdiv_rn(tf, sqrt_dh);
    wl[j] = total;
  }
  // the v rows, in flight while the softmax runs
#pragma unroll
  for (int j = 0; j < kContexts; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < mine) vr[j][c] = W::load(r.v[j] + c * KV);
  softmax5(wf);
  if (__any_sync(kAll, two)) {  // else no lane of the warp has a second
#pragma unroll
    for (int j = 0; j < kContexts; ++j) wl[j] = __fdiv_rn(wl[j], sqrt_dh);
    softmax5(wl);
  }

#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c >= mine) continue;
    float acc[KV];
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      const bool first = a + c * KV + t < bound;
      acc[t] = 0.f;
#pragma unroll
      for (int j = 0; j < kContexts; ++j)
        acc[t] = fmaf(first ? wf[j] : wl[j], W::at(vr[j][c], t), acc[t]);
    }
    W::store(r.out + c * KV, acc);
  }
}

// Heads: a warp per (row, head), lane l taking the head's chunks l, l + 32,
// ... in order, the partials summed by a butterfly (every lane the same
// bits).
template <typename T, int CB>
__global__ void __launch_bounds__(kWarps * 32)
star_head_kernel(const T* __restrict__ q, const T* __restrict__ kh,
                 const T* __restrict__ vh, const T* __restrict__ ke,
                 const T* __restrict__ ve, const T* __restrict__ ks,
                 const T* __restrict__ vs, T* __restrict__ out, int n,
                 int len, int d, int heads, float sqrt_dh) {
  using W = Vec<T, CB>;
  constexpr int KV = W::KV;
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)n * heads) return;  // the whole warp
  const int row = (int)(w / heads);
  const int dh = d / heads;
  const Rows<T> r(q, kh, vh, ke, ve, ks, vs, out, row, len, d,
                  (w - row * heads) * dh);
  const int nch = dh / KV;
  float s[kContexts] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = lane; c < nch; c += 32) {
    const typename W::V qc = W::load(r.q + c * KV);
    typename W::V kc[kContexts];
#pragma unroll
    for (int j = 0; j < kContexts; ++j) kc[j] = W::load(r.k[j] + c * KV);
#pragma unroll
    for (int j = 0; j < kContexts; ++j)
#pragma unroll
      for (int t = 0; t < KV; ++t)
        s[j] = fmaf(W::at(qc, t), W::at(kc[j], t), s[j]);
  }
#pragma unroll
  for (int j = 0; j < kContexts; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[j] += __shfl_xor_sync(kAll, s[j], o);
    s[j] = __fdiv_rn(s[j], sqrt_dh);
  }
  softmax5(s);
  for (int c = lane; c < nch; c += 32) {
    typename W::V vc[kContexts];
#pragma unroll
    for (int j = 0; j < kContexts; ++j) vc[j] = W::load(r.v[j] + c * KV);
    float acc[KV];
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      acc[t] = 0.f;
#pragma unroll
      for (int j = 0; j < kContexts; ++j)
        acc[t] = fmaf(s[j], W::at(vc[j], t), acc[t]);
    }
    W::store(r.out + c * KV, acc);
  }
}

// The plan for width d in `heads` heads of elements of `size` bytes, into
// out[4]: (path: 0 rows, 1 heads; chunk bytes CB; chunks a lane C, 1 on
// the heads path; lanes a row G, 32 on the heads path). -1 when the
// arguments are bad. ops/star_kernel.py `wide_plan` mirrors it.
int wide_plan(int d, int heads, int size, int* out) {
  if (d <= 0 || heads <= 0 || d % heads || (size != 2 && size != 4))
    return -1;
  const int dh = d / heads;
  for (int cb = 16; cb >= size; cb /= 2) {
    if ((d * size) % cb) continue;
    const int kv = cb / size;
    const int nc = d / kv;
    for (int c = 1; c <= kMaxChunks && c * kv <= dh; c *= 2) {
      if (nc <= 32 * c) {
        out[0] = 0;
        out[1] = cb;
        out[2] = c;
        out[3] = (nc + c - 1) / c;
        return 0;
      }
    }
  }
  int cb = 16;
  while ((dh * size) % cb) cb /= 2;
  out[0] = 1;
  out[1] = cb;
  out[2] = 1;
  out[3] = 32;
  return 0;
}

struct Ring {
  const void *q, *kh, *vh, *ke, *ve, *ks, *vs;
  void* out;
};

template <typename T, int CB, int C>
int launch_group(const Ring& r, int n, int len, int d, int heads,
                 int g_lanes, cudaStream_t st) {
  const int dh = d / heads;
  constexpr int E = C * CB / (int)sizeof(T);
  const long long warps = (n + 32 / g_lanes - 1) / (32 / g_lanes);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > (1ll << 31) - 1) return (int)cudaErrorInvalidValue;
  star_group_kernel<T, CB, C><<<(unsigned)blocks, kWarps * 32, 0, st>>>(
      (const T*)r.q, (const T*)r.kh, (const T*)r.vh, (const T*)r.ke,
      (const T*)r.ve, (const T*)r.ks, (const T*)r.vs, (T*)r.out, n, len, d,
      dh, g_lanes, (dh + E - 1) / E + 1, (float)sqrt((double)dh));
  return (int)cudaGetLastError();
}

template <typename T, int CB>
int launch_heads(const Ring& r, int n, int len, int d, int heads,
                 cudaStream_t st) {
  const long long blocks = ((long long)n * heads + kWarps - 1) / kWarps;
  if (blocks > (1ll << 31) - 1) return (int)cudaErrorInvalidValue;
  star_head_kernel<T, CB><<<(unsigned)blocks, kWarps * 32, 0, st>>>(
      (const T*)r.q, (const T*)r.kh, (const T*)r.vh, (const T*)r.ke,
      (const T*)r.ve, (const T*)r.ks, (const T*)r.vs, (T*)r.out, n, len, d,
      heads, (float)sqrt((double)(d / heads)));
  return (int)cudaGetLastError();
}

template <typename T, int CB>
int launch_cb(const Ring& r, const int* plan, int n, int len, int d,
              int heads, cudaStream_t st) {
  if (plan[0] == 1) return launch_heads<T, CB>(r, n, len, d, heads, st);
  switch (plan[2]) {
    case 1:
      return launch_group<T, CB, 1>(r, n, len, d, heads, plan[3], st);
    case 2:
      return launch_group<T, CB, 2>(r, n, len, d, heads, plan[3], st);
    default:
      return launch_group<T, CB, kMaxChunks>(r, n, len, d, heads, plan[3],
                                             st);
  }
}

template <typename T>
int launch(const Ring& r, int b, int len, int d, int heads, void* stream) {
  int plan[4];
  if (b <= 0 || len <= 0 ||
      wide_plan(d, heads, (int)sizeof(T), plan) != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)b * len > (1ll << 30)) return (int)cudaErrorInvalidValue;
  const int n = b * len;
  cudaStream_t st = (cudaStream_t)stream;
  switch (plan[1]) {
    case 16:
      return launch_cb<T, 16>(r, plan, n, len, d, heads, st);
    case 8:
      return launch_cb<T, 8>(r, plan, n, len, d, heads, st);
    case 4:
      return launch_cb<T, 4>(r, plan, n, len, d, heads, st);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_cb<T, 2>(r, plan, n, len, d, heads, st);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The plan for width d in `heads` heads of `size`-byte elements (4 f32, 2
// bf16), into out[4]: path (0: a group of lanes per row, 1: a warp per
// row and head), chunk bytes, chunks a lane, lanes a row. Returns 0, or
// cudaErrorInvalidValue for bad arguments.
int deepsc_star_wide_plan(int d, int heads, int size, int* out) {
  return wide_plan(d, heads, size, out) ? (int)cudaErrorInvalidValue : 0;
}

// q, kh, vh, ke, ve, out: contiguous (B, L, D); ks, vs: contiguous (B, D);
// all 16-byte aligned; any D >= 1 and heads dividing it; N = B L at most
// 2^30. Returns cudaGetLastError() after the launch (0 = success).
int deepsc_star_wide_f32(const void* q, const void* kh, const void* vh,
                         const void* ke, const void* ve, const void* ks,
                         const void* vs, void* out, int b, int len, int d,
                         int heads, void* stream) {
  return launch<float>(Ring{q, kh, vh, ke, ve, ks, vs, out}, b, len, d,
                       heads, stream);
}

int deepsc_star_wide_bf16(const void* q, const void* kh, const void* vh,
                          const void* ke, const void* ve, const void* ks,
                          const void* vs, void* out, int b, int len, int d,
                          int heads, void* stream) {
  return launch<__nv_bfloat16>(Ring{q, kh, vh, ke, ve, ks, vs, out}, b, len,
                               d, heads, stream);
}

}  // extern "C"
