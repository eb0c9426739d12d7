// Tensor-core pieces of the bf16 vocab kernels (the cross entropy of
// csrc/ce_fwd.cu and csrc/ce_bwd.cu, and the beam scorer of csrc/topk.cu)
// for Hopper (sm_90a): TMA loads into 128-byte-swizzled shared memory,
// mbarriers, wgmma descriptors and the three warpgroup products the
// kernels use, as inline PTX.
//
// Layout. h (N, D) and the vocab table W (V, D) are row-major bf16, so a
// tile of R rows is R x D with D contiguous. In shared memory a tile is
// cut into "slabs" of 64 columns (128 bytes a row): slab s holds columns
// [64 s, 64 s + 64) of all R rows, row r at byte 128 r of the slab, its
// 16-byte chunk c stored at chunk c ^ (r % 8) (the 128-byte swizzle, which
// the TMA applies on its way in: CU_TENSOR_MAP_SWIZZLE_128B). Slabs are
// 1024-byte aligned. Columns past D and rows past the tensor's end are
// zero-filled by the TMA, so no padded copy of W is ever made. D is a
// multiple of 16 up to 256 (at most four slabs); the logits alone also take
// a multiple of 8, whose last k-step reads the TMA's zeros past D.
//
// The same slab serves two products:
// - as a K-major operand (K = D): the logits h_t . W_t^T, where both h and
//   W are K-major. The descriptor of k-step kk (16 columns) starts at slab
//   kk / 4, byte 32 (kk % 4); stride between 8-row groups (SBO) 1024 bytes.
// - as an MN-major operand (N = 64 columns of D, K = rows of the tile):
//   the products P . W_t (dh) and P^T . h_t (dW). k-step kk (16 rows)
//   starts at byte 2048 kk of the slab; the 8-row groups along K are 1024
//   bytes apart. An instruction of N = 64 spans one swizzle atom along N,
//   so the other stride is not used (it is set to the same 1024).
//
// Accumulators. An m64nN f32 accumulator of a warpgroup gives thread t
// (warp w = t / 32, lane l) N / 2 values; value q is row
// 16 w + l / 4 + 8 ((q / 2) % 2), column 8 (q / 4) + 2 (l % 4) + q % 2.
// Columns [16 kk, 16 kk + 16) of it, rounded to bf16 and packed in pairs,
// are the register A operand of k-step kk of a product with K = N: the
// identity FlashAttention-3 uses for P . V.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int kThreads = 128;    // one warpgroup
constexpr int kRows = 64;        // wgmma M: rows of the resident tile
constexpr int kSlabCols = 64;    // bf16 columns per 128-byte slab row
constexpr int kRowBytes = 128;
constexpr int kMaxSlabs = 4;     // D up to 256
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int slabs(int d) {
  return (d + kSlabCols - 1) / kSlabCols;
}

// bytes of a tile of `rows` rows and D columns in shared memory
__host__ __device__ constexpr int tile_bytes(int rows, int d) {
  return slabs(d) * rows * kRowBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned address at or after p (the swizzle atom)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// spin until the phase of parity `parity` has completed; a phase that does
// not complete within 10 s (a lost TMA transaction) traps, so the launch
// fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = global_ns();
    } else if (global_ns() - start > 10000000000ull) {
      __trap();
    }
  }
}

// ---- TMA ----

// one box of a 2-D tensor map (64 columns from column `col`, the map's box
// rows from row `row`) -> dst; completes on `bar`, whose expected bytes the
// caller sets (mbar_expect_tx)
__device__ __forceinline__ void load_box(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// rows [row0, row0 + rows) of a 2-D bf16 tensor map whose box is
// (64 columns, rows) -> the slabs at dst; completes on `bar`, which is
// told to expect the bytes of every box (zero-filled parts included).
// Called by one thread.
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row0, int rows,
                                          int d) {
  const int ns = slabs(d);
  mbar_expect_tx(bar, (uint32_t)(ns * rows * kRowBytes));
  for (int s = 0; s < ns; ++s)
    load_box(dst + s * rows * kRowBytes, map, bar, s * kSlabCols, row0);
}

// ---- wgmma ----

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);  // 128-byte swizzle
}

// k-step kk (16 columns of D) of a K-major tile of `rows` rows at `addr`
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int rows, int kk) {
  return desc(addr + (kk >> 2) * rows * kRowBytes + (kk & 3) * 32, 16, 1024);
}

// k-step kk (rows 16 kk ..) of slab s of a tile of `rows` rows at `addr`,
// as an MN-major operand of 64 columns
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int rows, int s,
                                            int kk) {
  return desc(addr + s * rows * kRowBytes + kk * 16 * kRowBytes, 1024, 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of the registers across
// the asynchronous products (and so into a product's pipeline stage, which
// would serialize the products)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A . B, m64n128k16: A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A . B, m64n64k16: A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A . B, m64n64k16: A in registers, B MN-major in shared memory
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t* a,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// acc = A . B^T, (64 x N) f32, over all 16-column k-steps of D: A (64 x D)
// at `a` and B (N x D) at `b`, both K-major tiles of NS slabs (D <= 64 NS)
// in shared memory, zero past D. The k loop is unrolled to its most steps,
// so the accumulator keeps its registers.
template <int N, int NS>
__device__ __forceinline__ void logits(float (&acc)[N / 2], uint32_t a,
                                       uint32_t b, int d) {
  fence_regs(acc);
  fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NS; ++kk) {
    if (kk < (d + 15) / 16) {
      const uint64_t da = desc_k(a, kRows, kk);
      const uint64_t db = desc_k(b, N, kk);
      if constexpr (N == 128)
        mma_ss_n128(acc, da, db, kk > 0);
      else
        mma_ss_n64(acc, da, db, kk > 0);
    }
  }
  commit();
  wait_all();
  fence_regs(acc);
}

// the accumulator p (64 x 64, f32) rounded to bf16: the A operand of four
// 16-row k-steps, a[4 kk .. 4 kk + 3] for step kk
__device__ __forceinline__ void to_a(const float (&p)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
    a[i] = *reinterpret_cast<const uint32_t*>(&x);
  }
}

// acc[s] (+)= P . B[:, 64 s .. 64 s + 64) for every slab s < NC: P
// (64 x 64) in registers (to_a), B a tile of 64 rows at `b` read MN-major;
// the first call (first != 0) overwrites acc
template <int NC>
__device__ __forceinline__ void accumulate(float (&acc)[NC][32],
                                           uint32_t (&a)[16], uint32_t b,
                                           int first) {
  fence_regs(a);
#pragma unroll
  for (int s = 0; s < NC; ++s) fence_regs(acc[s]);
  fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int s = 0; s < NC; ++s)
      mma_rs_n64(acc[s], a + 4 * kk, desc_mn(b, kRows, s, kk),
                 kk > 0 || !first);
  commit();
  wait_all();
#pragma unroll
  for (int s = 0; s < NC; ++s) fence_regs(acc[s]);
  fence_regs(a);  // the products read a until they retire
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's
// entry-point query so that the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// map of a row-major bf16 (rows, d) tensor with a box of (64 columns,
// box_rows rows), 128-byte swizzle, zero fill out of bounds. 0 on success.
inline int make_map(CUtensorMap* map, const void* ptr, int rows, int d,
                    int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {(cuuint32_t)kSlabCols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace wg
