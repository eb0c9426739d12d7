#!/usr/bin/env python3
"""What bounds the bf16 K1, K2, K5 and K6, the narrow f32 K1/K2, the f32
K6 and the wide K5: each built as it is and with one part changed or taken
out, timed on one card.

    python3 scripts/kernel_variants.py [--iters 50]
        [--sources attention_fwd,attention_bwd,star_satellite,topk,
                   attention_narrow,topk_f32,star_wide]

Every variant is an edited copy of `csrc/attention_fwd.cu`,
`csrc/attention_bwd.cu`, `csrc/star_satellite.cu`, `csrc/topk.cu` (the
sources `topk` and `topk_f32`), `csrc/star_wide.cu` or
`csrc/attention_narrow.cu` (the edit is a text replacement
that must match the source), built with the port's nvcc flags in a
temporary directory and called through its own C interface at the paths'
shapes, on the inputs chip_smoke.py gives the kernels. Variants:
- K1 (N = 1,216 and 64, Lq = Lk = 31, 8 heads of 16): `as_is`;
  `ieee_div`, e / sum by `__fdiv_rn` instead of the reciprocal and one fma
  correction; `no_softmax`, no products or softmax at all (the row's
  loads and the stores alone: the kernel's floor as designed).
- K2 (the training path's N = 64, the encoder's, decoder self and cross
  attentions, 8 heads of 16, no dbias): `as_is`; `heads_1`,
  `heads_2`, `heads_16`, blocks of (at most) that many heads of a row
  instead of 4 (`heads_16`: all of them, a block per row, as with dbias);
  `no_products`, no products or softmax at all (the row's loads and the
  stores alone: the kernel's floor as designed).
- K5 (the star sweep decoder's B = 19 x 64 and the train step's B = 64,
  L = 31, D = 128, 8 heads): `as_is`; `rows_4`, `rows_16`, blocks of that
  many rows (a warp each) instead of 8.
- the narrow f32 K1 (N = 1,216 and 64, Lq = Lk = 31, and N = 64 at 128 x
  128, 8 heads of 16) and K2 (N = 64 at the training path's three shapes
  and at 128 x 128, no dbias), one library: `as_is`; `ieee_div`, e / sum
  by `__fdiv_rn` instead of `div_rn`; `no_products`, no logits, softmax
  or sums (K1's key tiles and the short K2's three phases empty: the
  staging and the stores alone, the design's floor); `fwd_blocks_6`, K1
  built for 6 blocks an SM instead of 8 (`kFwdBlocks`: up to 80 registers
  a thread instead of 64), `fwd_unbounded` for none (96); `bwd_blocks_8`,
  the short K2 built for 8 (64).
- K6 (N = 256 and 4,864, k = 4, V = 22,234; and N = 256, k = 8):
  `as_is`; `no_quad`, without the quad's shared threshold; `swap_insert`,
  every insertion by the merge's compare-and-swap pass (index compares
  included) instead of the shift; `no_lists`, no top-k lists (the
  softmax sums alone).
- the f32 K6 (`topk_tiled_kernel`; N = 256 at k = 1, 4 and 8, N = 4,864
  at k = 4; D = 128, V = 22,234, dyadic operands): `as_is`;
  `blocks_2`, built for two blocks of 256 an SM (at most 128 registers a
  thread: the lists spill), with the splits that the variant's tiling
  gives; `row_filter`, a logit entering only if it is also not below the
  row's threshold (the largest last entry of its 16 lists, a half-warp max
  a tile); `insert_merge`,
  the row's 16 lists merged by insertion instead of bitonic merges;
  `no_lists`, no top-k lists (the products and the softmax sums alone).
- the wide K5 (B = 64, L = 31, D = 96 and 512 in 8 heads, bf16 and f32):
  `as_is`; `warps_4`, blocks of 4 warps instead of 8; `chunk_8`, chunks
  of at most 8 bytes (the plan's path and lanes as the variant's
  `deepsc_star_wide_plan` gives them); `early_v`, the v rows loaded with
  q and k, before the scores (all eleven loads of a row in flight).
Prints each variant's max error against the plain version (K6: whether
its indices equal the plain version's) and its device time per call
(`chip_smoke.device_ms`: the calls queued behind a spin of the device),
with the card's name and power limit. Then (with `attention_fwd`) holds
K1's and K2's `div_rn`
(its text taken from `csrc/mma_row.cuh`) bit for bit against `__fdiv_rn`
over 2^32 pairs
(a, b): a in [0, 1) and b in [1, 32) as K1's e and sum, and a any normal
float below 1. Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from deepsc_gan_tpu_torch.ops import attention_kernel as attn  # noqa: E402
from deepsc_gan_tpu_torch.ops import build  # noqa: E402
from deepsc_gan_tpu_torch.ops import ce_kernel as ce  # noqa: E402
from deepsc_gan_tpu_torch.ops import star_kernel as star  # noqa: E402
from deepsc_gan_tpu_torch.ops import topk_kernel as topk  # noqa: E402

K1_DIV = (
    """        pa[kk][2 * half] = pack_bf16(div_rn(x[0], sum[0], rs[0]),
                                     div_rn(x[1], sum[0], rs[0]));
        pa[kk][2 * half + 1] = pack_bf16(div_rn(x[2], sum[1], rs[1]),
                                         div_rn(x[3], sum[1], rs[1]));""",
    """        pa[kk][2 * half] = pack_bf16(__fdiv_rn(x[0], sum[0]),
                                     __fdiv_rn(x[1], sum[0]));
        pa[kk][2 * half + 1] = pack_bf16(__fdiv_rn(x[2], sum[1]),
                                         __fdiv_rn(x[3], sum[1]));""")
K1_NONE = ("  const int mtiles = lq > 16 ? 2 : 1;", "  const int mtiles = 0;")
K6_CHECK = """        if (x >= tq && x > lv[i][L - 1])
          insert_new(lv[i], li[i], x, c0 + 8 * q + e);"""
K6_QUAD = (K6_CHECK, """        if (x > lv[i][L - 1])
          insert_new(lv[i], li[i], x, c0 + 8 * q + e);""")
K6_SWAP = (K6_CHECK, """        if (x >= tq && x > lv[i][L - 1])
          insert(lv[i], li[i], x, c0 + 8 * q + e);""")
K6_NONE = (K6_CHECK, "")
K6F_BOUNDS = ("__launch_bounds__(tiled::kThreads, 1)\ntopk_tiled_kernel(",
              "__launch_bounds__(tiled::kThreads, 2)\ntopk_tiled_kernel(")
K6F_LOOP = """#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + at(tx, j);
        if (c < v && acc[i][j] > lv[i][L - 1])"""
K6F_CHECK = """        if (c < v && acc[i][j] > lv[i][L - 1])
          insert_new(lv[i], li[i], acc[i][j], c);"""
K6F_FILTER = (K6F_LOOP, "      const float tq = tiled::half_warp_max(lv[i][L - 1]);\n"
              + K6F_LOOP.replace("acc[i][j] > lv", "acc[i][j] >= tq && "
                                 "acc[i][j] > lv"))
K6F_INSERT = ("      merge_sorted(lv[i], li[i], ov, oi);",
              "      for (int t = 0; t < L; ++t) "
              "insert(lv[i], li[i], ov[t], oi[t]);")
K6F_NONE = (K6F_CHECK, "")

K5W_EARLY = """  typename W::V qr[C], kr[kContexts][C], vr[kContexts][C];
"""
K5W_LATE = """  // the v rows, in flight while the softmax runs
"""
K5W_V = """#pragma unroll
  for (int j = 0; j < kContexts; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < mine) vr[j][c] = W::load(r.v[j] + c * KV);
"""

K2_HEADS = "constexpr int kHeadsPerBlock = 4;"
K5_ROWS = "constexpr int kRowsPerBlock = 8;"
K2_NONE_Q = ("  const int mq = lq > 16 ? 2 : 1;", "  const int mq = 0;")
K2_NONE_K = ("  const int mk = lk > 16 ? 2 : 1;", "  const int mk = 0;")

K1N_NONE = ("    const int kn = min(kRows, sh.lk - t * kRows);",
            "    const int kn = 0;")
K1N_DIV = ("        if (c + 4 * u < kn) prow[c + 4 * u] = "
           "div_rn(s[u], sum, r);",
           "        if (c + 4 * u < kn) prow[c + 4 * u] = "
           "__fdiv_rn(s[u], sum);")
K2N_DIV = ("        s[u] = div_rn(s[u], sum, rs);",
           "        s[u] = __fdiv_rn(s[u], sum);")
K2N_NONE = [
    ("  // ---- 1. a quad per query: s, dp, p, rowsum(dp p), ds and dss\n  {",
     "  // ---- 1. a quad per query: s, dp, p, rowsum(dp p), ds and dss\n"
     "  if (sh.n < 0) {"),
    ("    weighted_rows(acc, ws + r * kRowStride, ks + c * C, S, sh.lk);",
     "    weighted_rows(acc, ws + r * kRowStride, ks + c * C, S, 0);"),
    ("    for (int i = 0; i < sh.lq; ++i) {\n      axpy(ak",
     "    for (int i = 0; i < 0; ++i) {\n      axpy(ak")]


def narrow_bounds(kernel, blocks):
    """`kernel`'s launch bounds with at least `blocks` blocks an SM."""
    return (f"__launch_bounds__(kThreads)\n{kernel}(",
            f"__launch_bounds__(kThreads, {blocks})\n{kernel}(")

VARIANTS = {
    "attention_fwd": {"as_is": [], "ieee_div": [K1_DIV],
                      "no_softmax": [K1_NONE]},
    "attention_bwd": {"as_is": [],
                      **{f"heads_{n}": [(K2_HEADS, K2_HEADS.replace(
                          "4", str(n)))] for n in (1, 2, 16)},
                      "no_products": [K2_NONE_Q, K2_NONE_K]},
    "star_satellite": {"as_is": [],
                       **{f"rows_{n}": [(K5_ROWS,
                                         K5_ROWS.replace("8", str(n)))]
                          for n in (4, 16)}},
    "topk": {"as_is": [], "no_quad": [K6_QUAD], "swap_insert": [K6_SWAP],
             "no_lists": [K6_NONE]},
    "attention_narrow": {
        "as_is": [], "ieee_div": [K1N_DIV, K2N_DIV],
        "no_products": [K1N_NONE, *K2N_NONE],
        "fwd_blocks_6": [("constexpr int kFwdBlocks = 8;",
                          "constexpr int kFwdBlocks = 6;")],
        "fwd_unbounded": [("__launch_bounds__(kThreads, kFwdBlocks)",
                           "__launch_bounds__(kThreads)")],
        "bwd_blocks_8": [narrow_bounds("attention_narrow_bwd_kernel", 8)]},
    "topk_f32": {"as_is": [], "blocks_2": [K6F_BOUNDS],
                 "row_filter": [K6F_FILTER], "insert_merge": [K6F_INSERT],
                 "no_lists": [K6F_NONE]},
    "star_wide": {"as_is": [],
                  "warps_4": [("constexpr int kWarps = 8;",
                               "constexpr int kWarps = 4;")],
                  "chunk_8": [("for (int cb = 16; cb >= size; cb /= 2) {",
                               "for (int cb = 8; cb >= size; cb /= 2) {")],
                  "early_v": [(K5W_LATE, ""),
                              (K5W_EARLY, K5W_EARLY + K5W_V)]},
}
# the source file of a variant set named otherwise
SOURCE = {"topk_f32": "topk"}


def build_all(tmp: Path, sources) -> dict:
    """Every variant's library of `sources`, all nvcc processes started
    together."""
    jobs = {}
    for src in sources:
        variants = VARIANTS[src]
        text = (build.CSRC / f"{SOURCE.get(src, src)}.cu").read_text()
        for name, edits in variants.items():
            s = text
            for old, new in edits:
                if s.count(old) != 1:
                    raise RuntimeError(f"{src} {name}: the edit does not "
                                       f"match the source once")
                s = s.replace(old, new)
            path = tmp / f"{src}_{name}.cu"
            path.write_text(s)
            lib = tmp / f"lib{src}_{name}.so"
            cmd = build.nvcc_command(path, lib, build.find_nvcc())
            cmd[1:1] = ["-I", str(build.CSRC)]
            jobs[(src, name)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


DIVISION = r"""
#include <cuda_runtime.h>
#include <stdint.h>
%s
__device__ uint32_t mix(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu;
  return x ^ (x >> 16);
}
// per thread `per` pairs; mode 0: a in [0, 1), b in [1, 32); mode 1: a any
// normal float below 1, b in [1, 32)
// count[0]: quotients that differ; count[1]: those of them that are normal
__global__ void differ(unsigned long long* count, int per, int mode) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long n = 0, normal = 0;
  for (int i = 0; i < per; ++i) {
    const uint32_t h1 = mix(t * 2654435761u + i * 40503u + 1u);
    const uint32_t h2 = mix(h1 ^ 0x9e3779b9u);
    const float a = mode == 0 ? (h1 >> 8) * (1.f / 16777216.f)
        : __uint_as_float(0x00800000u + h1 %% (0x3f800000u - 0x00800000u));
    const float b = 1.f + (h2 >> 8) * (31.f / 16777216.f);
    const float want = __fdiv_rn(a, b);
    if (__float_as_uint(div_rn(a, b, __frcp_rn(b))) !=
        __float_as_uint(want)) {
      ++n;
      normal += want >= 1.17549435e-38f;
    }
  }
  atomicAdd(count, n);
  atomicAdd(count + 1, normal);
}
extern "C" int run(void* count, int mode) {
  differ<<<4096, 256>>>((unsigned long long*)count, 4096, mode);
  return (int)cudaDeviceSynchronize();
}
"""


def division_check(tmp: Path):
    """K1's and K2's div_rn against __fdiv_rn, 2^32 pairs per mode."""
    text = (build.CSRC / "mma_row.cuh").read_text()
    fn = re.search(r"__device__ __forceinline__ float div_rn\(.*?\n}\n",
                   text, re.S)
    if fn is None:
        raise RuntimeError("div_rn not found in csrc/mma_row.cuh")
    src, lib = tmp / "division.cu", tmp / "libdivision.so"
    src.write_text(DIVISION % fn.group(0))
    subprocess.run(build.nvcc_command(src, lib, build.find_nvcc()),
                   check=True, capture_output=True)
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_void_p, ctypes.c_int]
    run.restype = ctypes.c_int
    for mode, what in ((0, "a in [0, 1)"), (1, "a any normal float < 1")):
        count = torch.zeros(2, dtype=torch.int64, device="cuda")
        if run(count.data_ptr(), mode):
            raise RuntimeError("division check: CUDA error")
        differ, normal = count.tolist()
        print(f"[division] div_rn vs __fdiv_rn, {what}, b in [1, 32): "
              f"{differ} of {4096 * 256 * 4096} quotients differ, {normal} "
              f"of them normal", flush=True)


def stream():
    return torch.cuda.current_stream().cuda_stream


def k1_rows(libs, gen, iters):
    for n in (1216, 64):
        q, k, v, bias = cs.attention_inputs(n, 31, 31, torch.bfloat16, gen,
                                            True)
        ref = attn.attention_fwd_reference(q, k, v, bias, cs.HEADS, 4.0)
        out = torch.empty_like(q)
        for name in VARIANTS["attention_fwd"]:
            fn = libs[("attention_fwd", name)].deepsc_attention_fwd_bf16
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_double, ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         bias.data_ptr(), out.data_ptr(), n, 31, 31,
                         cs.HEADS, cs.DH, 4.0, stream())
                if err:
                    raise RuntimeError(f"K1 {name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            print(f"[variant] K1 {name:11s} N={n:5d}: max err {err:.3g}, "
                  f"device_ms {cs.device_ms(call, iters)!r}", flush=True)


def k2_rows(libs, gen, iters):
    for label, lq, lk in cs.TRAIN_SHAPES:
        n = 64
        q, k, v, bias = cs.attention_inputs(n, lq, lk, torch.bfloat16, gen,
                                            lq == lk)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        ref = attn.attention_bwd_reference(q, k, v, bias, g, cs.HEADS, 4.0,
                                           False)[:3]
        outs = [torch.empty_like(t) for t in (q, k, v)]
        for name in VARIANTS["attention_bwd"]:
            fn = libs[("attention_bwd", name)].deepsc_attention_bwd_bf16
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                           + [ctypes.c_double, ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         bias.data_ptr(), g.data_ptr(),
                         *(t.data_ptr() for t in outs), None, n, lq, lk,
                         cs.HEADS, cs.DH, 4.0, stream())
                if err:
                    raise RuntimeError(f"K2 {name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(outs, ref))
            print(f"[variant] K2 {name:14s} {label:13s}: max err {err:.3g}, "
                  f"device_ms {cs.device_ms(call, iters)!r}", flush=True)


def k5_rows(libs, gen, iters):
    for label, b in (("star_sweep", 19 * 64), ("star_train", 64)):
        ring = [torch.randn((b, 31, 128) if i < 5 else (b, 128),
                            generator=gen, device="cuda").to(torch.bfloat16)
                for i in range(7)]
        ref = star.ring_reference(*ring, cs.HEADS)
        out = torch.empty_like(ring[0])
        for name in VARIANTS["star_satellite"]:
            fn = libs[("star_satellite", name)].deepsc_star_satellite_bf16
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def call():
                err = fn(*(t.data_ptr() for t in ring), out.data_ptr(), b,
                         31, 128, cs.HEADS, stream())
                if err:
                    raise RuntimeError(f"K5 {name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            print(f"[variant] K5 {name:14s} {label:10s}: max err {err:.3g}, "
                  f"device_ms {cs.device_ms(call, iters)!r}", flush=True)


def narrow_rows(libs, gen, iters):
    f32 = torch.float32
    for n, lq, lk in ((1216, 31, 31), (64, 31, 31), (64, 128, 128)):
        q, k, v, bias = cs.attention_inputs(n, lq, lk, f32, gen, lq == lk)
        ref = attn.attention_fwd_reference(q, k, v, bias, cs.HEADS, 4.0)
        out = torch.empty_like(q)
        for name in VARIANTS["attention_narrow"]:
            fn = libs[("attention_narrow", name)] \
                .deepsc_attention_narrow_fwd_f32
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_double, ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         bias.data_ptr(), out.data_ptr(), n, lq, lk,
                         cs.HEADS, cs.DH, 4.0, stream())
                if err:
                    raise RuntimeError(f"narrow K1 {name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            print(f"[variant] narrow K1 {name:13s} N={n:5d} {lq}x{lk}: max "
                  f"err {err:.3g}, device_ms {cs.device_ms(call, iters)!r}",
                  flush=True)
    for label, lq, lk in cs.TRAIN_SHAPES + (("long_128", 128, 128),):
        n = 64
        q, k, v, bias = cs.attention_inputs(n, lq, lk, f32, gen, lq == lk)
        g = torch.randn(q.shape, generator=gen, device="cuda")
        ref = attn.attention_bwd_reference(q, k, v, bias, g, cs.HEADS, 4.0,
                                           False)[:3]
        outs = [torch.empty_like(t) for t in (q, k, v)]
        floats = attn.narrow_bwd_scratch_floats(n, lq, lk, cs.HEADS, False)
        scratch = torch.empty(max(floats, 1), dtype=f32, device="cuda")
        for name in VARIANTS["attention_narrow"]:
            fn = libs[("attention_narrow", name)] \
                .deepsc_attention_narrow_bwd_f32
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                           + [ctypes.c_double, ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         bias.data_ptr(), g.data_ptr(),
                         *(t.data_ptr() for t in outs), None,
                         scratch.data_ptr(), n, lq, lk, cs.HEADS, cs.DH, 4.0,
                         stream())
                if err:
                    raise RuntimeError(f"narrow K2 {name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(outs, ref))
            print(f"[variant] narrow K2 {name:13s} {label:13s}: max err "
                  f"{err:.3g}, device_ms {cs.device_ms(call, iters)!r}",
                  flush=True)


def k6_rows(libs, gen, iters):
    d, v = 128, 22234
    for n, k in ((256, 4), (4864, 4), (256, 8)):
        h = cs.dyadic((n, d), 8, gen, torch.bfloat16)
        W = cs.dyadic((v, d), 2, gen, torch.bfloat16)
        b = cs.dyadic((v,), 8, gen, torch.float32)
        ref = topk.topk_logits_reference(h, W, b, k)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = ce.vocab_splits(n, v, sms, *ce.tiling(
            topk.KERNEL, torch.bfloat16, d, h.device))
        f32 = {"dtype": torch.float32, "device": "cuda"}
        vals, lse = torch.empty((n, k), **f32), torch.empty(n, **f32)
        idx = torch.empty((n, k), dtype=torch.int32, device="cuda")
        part_v = torch.empty((splits, n, topk.MAX_K), **f32)
        part_i = torch.empty((splits, n, topk.MAX_K), dtype=torch.int32,
                             device="cuda")
        part_ms = torch.empty((splits, n, 2), **f32)
        for name in VARIANTS["topk"]:
            fn = libs[("topk", name)].deepsc_topk_bf16
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def call():
                err = fn(h.data_ptr(), W.data_ptr(), b.data_ptr(),
                         vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
                         part_v.data_ptr(), part_i.data_ptr(),
                         part_ms.data_ptr(), n, d, v, k, splits, stream())
                if err:
                    raise RuntimeError(f"K6 {name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            print(f"[variant] K6 {name:11s} N={n:5d} k={k}: indices equal "
                  f"{torch.equal(idx, ref[1])}, lse err "
                  f"{(lse - ref[2]).abs().max().item():.3g}, device_ms "
                  f"{cs.device_ms(call, iters)!r}", flush=True)


def k6_f32_rows(libs, gen, iters):
    d, v = 128, 22234
    f32 = {"dtype": torch.float32, "device": "cuda"}
    for n, k in ((256, 4), (4864, 4), (256, 8), (256, 1)):
        h = cs.dyadic((n, d), 8, gen, torch.float32)
        W = cs.dyadic((v, d), 2, gen, torch.float32)
        b = cs.dyadic((v,), 8, gen, torch.float32)
        ref = topk.topk_logits_reference(h, W, b, k)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        vals, lse = torch.empty((n, k), **f32), torch.empty(n, **f32)
        idx = torch.empty((n, k), dtype=torch.int32, device="cuda")
        for name in VARIANTS["topk_f32"]:
            lib = libs[("topk_f32", name)]
            tiling = lib.deepsc_topk_tiling_f32
            tiling.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            out = (ctypes.c_int * 3)()
            if tiling(d, out):
                raise RuntimeError(f"f32 K6 {name}: tiling failed")
            splits = ce.vocab_splits(n, v, sms, *out)
            part_v = torch.empty((splits, n, topk.MAX_K), **f32)
            part_i = torch.empty((splits, n, topk.MAX_K), dtype=torch.int32,
                                 device="cuda")
            part_ms = torch.empty((splits, n, 2), **f32)
            fn = lib.deepsc_topk_f32
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def call():
                err = fn(h.data_ptr(), W.data_ptr(), b.data_ptr(),
                         vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
                         part_v.data_ptr(), part_i.data_ptr(),
                         part_ms.data_ptr(), n, d, v, k, splits, stream())
                if err:
                    raise RuntimeError(f"f32 K6 {name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            print(f"[variant] f32 K6 {name:12s} N={n:5d} k={k}: blocks an "
                  f"SM {out[2]}, splits {splits}, indices equal "
                  f"{torch.equal(idx, ref[1])}, lse err "
                  f"{(lse - ref[2]).abs().max().item():.3g}, device_ms "
                  f"{cs.device_ms(call, iters)!r}", flush=True)


def k5_wide_rows(libs, gen, iters):
    b, length = 64, 31
    for d in (96, 512):
        for dtype in (torch.bfloat16, torch.float32):
            ring = cs.star_ring(b, length, d, dtype, gen)
            ref = star.ring_reference(*ring, cs.HEADS)
            out = torch.empty_like(ring[0])
            suffix = "bf16" if dtype == torch.bfloat16 else "f32"
            for name in VARIANTS["star_wide"]:
                lib = libs[("star_wide", name)]
                plan = lib.deepsc_star_wide_plan
                plan.argtypes = ([ctypes.c_int] * 3
                                 + [ctypes.POINTER(ctypes.c_int)])
                got = (ctypes.c_int * 4)()
                if plan(d, cs.HEADS, dtype.itemsize, got):
                    raise RuntimeError(f"wide K5 {name}: plan failed")
                fn = getattr(lib, f"deepsc_star_wide_{suffix}")
                fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int

                def call():
                    err = fn(*(t.data_ptr() for t in ring), out.data_ptr(),
                             b, length, d, cs.HEADS, stream())
                    if err:
                        raise RuntimeError(f"wide K5 {name}: CUDA error "
                                           f"{err}")

                call()
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                print(f"[variant] wide K5 {name:8s} D={d:3d} {suffix:4s}: "
                      f"{('group', 'head')[got[0]]} path, {got[1]}-byte "
                      f"chunks, {got[2]} a lane, {got[3]} lanes, max err "
                      f"{err:.3g}, device_ms {cs.device_ms(call, iters)!r}",
                      flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--sources", default=",".join(VARIANTS),
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    args = ap.parse_args(argv)
    sources = args.sources.split(",")
    if not set(sources) <= set(VARIANTS):
        ap.error(f"--sources takes {', '.join(VARIANTS)}")
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    cs.phase_device()
    gen = torch.Generator("cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp), sources)
        for src, rows in (("attention_fwd", k1_rows),
                          ("attention_bwd", k2_rows),
                          ("star_satellite", k5_rows), ("topk", k6_rows),
                          ("attention_narrow", narrow_rows),
                          ("topk_f32", k6_f32_rows),
                          ("star_wide", k5_wide_rows)):
            if src in sources:
                rows(libs, gen, args.iters)
        if "attention_fwd" in sources:
            division_check(Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
