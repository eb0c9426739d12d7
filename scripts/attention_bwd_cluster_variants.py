#!/usr/bin/env python3
"""The bf16 cluster K2 (csrc/attention_bwd_cluster.cu) as built and with
one part changed, timed on one card.

    python3 scripts/attention_bwd_cluster_variants.py [--iters 20]
    python3 scripts/attention_bwd_cluster_variants.py --against-resident

With `--against-resident` it builds no variant: it times the K2 wrapper at
the resident kernel's shapes (csrc/attention_bwd_resident.cu: 33 to 128
queries and keys; N = 64, 8 heads of 16, bf16, with and without dbias) as
routed and with those calls sent to the cluster kernel as built instead,
and prints both device times and each one's largest error against the
plain version.

Each variant is an edited copy of `csrc/attention_bwd_cluster.cu` (each
edit a text replacement that must match the source once), built with the
port's nvcc flags in a temporary directory and called as the wrapper calls
the library, on chip_smoke.py's inputs (q, k, v, g ~ N(0, 1), a padded and
causal bias), N = 64, 8 heads of 16, bf16, no dbias:
- `as_built`;
- `timeline`: as built, with thread 0 of each block reading the global
  timer (ns) at the phase boundaries and summing each segment over the
  block's slices: the wait for a slice's staging, phase 1 up to its
  exchange (S, dP, the logits, the exponentials and their sums), the next
  slice's copies issued with p, ds, the tiles and the dq partials, the dq
  sum, phase 2, the stores (one block a row's head), the cluster's
  reduction. Prints the mean of each over the blocks, and their sum;
- `cluster_2`: clusters of two blocks a row's head even where the rows'
  heads fill the SMs (what the cluster's split of the slices and its
  reduction cost);
- `warps_8`: blocks of 8 warps (slices of half the queries), up to 128
  registers a thread so that two blocks share an SM (wrong past 256 keys:
  phase 2 keeps two key groups a warp);
- `no_dbias_code`: the ds scratch's stores compiled out (what their
  registers cost the call without dbias);
- `warp_row_fills`: the bias's -inf columns and zero rows a warp a row,
  without the divisions, and `element_copy4`: its 4-byte copies (Lk off 4)
  an element a thread, with one (what each does to the registers and the
  time);
- `no_dq`: no dQ products and no sum of the partials (wrong dq; what dQ
  costs).
Prints each variant's device time per call (`chip_smoke.device_ms`) and
its largest error against the plain version at 256 x 256, 255 x 256,
255 x 255, 31 x 256, 256 x 31 and 512 x 512; SDPA's backward beside them;
and the card's name and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from deepsc_gan_tpu_torch.ops import attention_kernel as attn  # noqa: E402
from deepsc_gan_tpu_torch.ops import build  # noqa: E402

N, HEADS, DH = 64, 8, 16
SHAPES = (("long_256", 256, 256), ("long_255x256", 255, 256),
          ("long_255", 255, 255), ("long_31x256", 31, 256),
          ("long_256x31", 256, 31), ("long_512", 512, 512))
POINTS = 7
TIMER = r"""
__device__ unsigned long long g_timeline[1 << 16][7];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TL_INIT                                                           \
  unsigned long long tl_last_ = 0, tl_acc_[7] = {0, 0, 0, 0, 0, 0, 0};    \
  if (threadIdx.x == 0) tl_last_ = gtimer();
#define TL(i)                                                             \
  if (threadIdx.x == 0) {                                                 \
    const unsigned long long t_ = gtimer();                               \
    tl_acc_[i] += t_ - tl_last_;                                          \
    tl_last_ = t_;                                                        \
  }
#define TL_STORE                                                          \
  if (threadIdx.x == 0) {                                                 \
    const long long b_ =                                                  \
        ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +    \
        blockIdx.x;                                                       \
    if (b_ < (1 << 16))                                                   \
      for (int i_ = 0; i_ < 7; ++i_) g_timeline[b_][i_] = tl_acc_[i_];    \
  }
"""
VARIANTS = {
    "as_built": [],
    "timeline": [
        ('#include "mma_row.cuh"\n', '#include "mma_row.cuh"\n' + TIMER),
        ("  const Layout sl = layout(lk, DH);\n"
         "  const int stride = sl.stride;",
         "  const Layout sl = layout(lk, DH);\n  TL_INIT;\n"
         "  const int stride = sl.stride;"),
        ("    __syncthreads();  // the slice staged; the last slice's "
         "products done",
         "    __syncthreads();  // the slice staged; the last slice's "
         "products done\n    TL(0);"),
        ("    __syncthreads();  // the chunks' maxima and sums; the bias read",
         "    __syncthreads();  // the chunks' maxima and sums; the bias read"
         "\n    TL(1);"),
        ("    __syncthreads();  // the tiles and the dq partials written",
         "    __syncthreads();  // the tiles and the dq partials written\n"
         "    TL(2);"),
        ("    if (sl.shared_dqx) {\n      __syncthreads();",
         "    TL(3);\n    if (sl.shared_dqx) {\n      __syncthreads();"),
        ("stride, nq, kg, 0, lane, pstride);\n    }\n  }\n",
         "stride, nq, kg, 0, lane, pstride);\n    }\n    TL(4);\n  }\n"),
        ("    return;\n  }\n  cg::cluster_group cluster",
         "    TL(5);\n    TL_STORE;\n    return;\n  }\n"
         "  cg::cluster_group cluster"),
        ("  cluster.sync();  // no block leaves while another reads its "
         "partials\n}",
         "  cluster.sync();  // no block leaves while another reads its "
         "partials\n  TL(6);\n  TL_STORE;\n}"),
        ('extern "C" {\n',
         'extern "C" {\n\nint deepsc_timeline(void* out, size_t bytes) {\n'
         '  return (int)cudaMemcpyFromSymbol(out, g_timeline, bytes);\n}\n')],
    "cluster_2": [("         (long long)n * heads * c < sms)",
                   "         c < 2)")],
    "warps_8": [("constexpr int kWarps = 16;", "constexpr int kWarps = 8;"),
                ("__global__ void __launch_bounds__(kThreads, 1)",
                 "__global__ void __launch_bounds__(kThreads, 2)")],
    "no_dbias_code": [("      if (ds_out != nullptr) {",
                       "      if (false) {")],
    "warp_row_fills": [(
        """  const int pad = sl.lkp - lk;
  for (int e = tid; e < sl.rows * pad; e += nt) {
    const int i = e / pad;
    bs[i * sl.bstride + lk + (e - i * pad)] = -INFINITY;
  }
  for (int e = tid; e < (sl.rows - rows) * lk; e += nt) {
    const int i = rows + e / lk;
    bs[i * sl.bstride + (e - (i - rows) * lk)] = 0.f;
  }""",
        """  for (int i = tid >> 5; i < sl.rows; i += nt >> 5) {
    float* d = bs + i * sl.bstride;
    if (lk + (tid & 31) < sl.lkp) d[lk + (tid & 31)] = -INFINITY;
    if (i >= rows)
      for (int j = tid & 31; j < lk; j += 32) d[j] = 0.f;
  }""")],
    "element_copy4": [(
        """    for (int i = tid >> 5; i < rows; i += nt >> 5)
      for (int j = tid & 31; j < lk; j += 32)
        cp_async4(bs + i * sl.bstride + j, bn + (long long)i * lk + j);""",
        """    for (int e = tid; e < rows * lk; e += nt) {
      const int i = e / lk;
      cp_async4(bs + i * sl.bstride + (e - i * lk), bn + e);
    }""")],
}


def build_variants(tmp: Path) -> dict:
    """Each variant's built library, their nvcc processes started
    together."""
    text = (build.CSRC / f"{attn.KERNEL_CLUSTER}.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        s = text
        for old, new in edits:
            if s.count(old) != 1:
                raise RuntimeError(f"{name}: an edit does not match the "
                                   f"source once: {old!r}")
            s = s.replace(old, new)
        path, lib = tmp / f"k2_{name}.cu", tmp / f"libk2_{name}.so"
        path.write_text(s)
        cmd = build.nvcc_command(path, lib, build.find_nvcc())
        cmd[1:1] = ["-I", str(build.CSRC)]
        jobs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in cs.ptxas_report(log):
            print(f"[ptxas] {name}: {line}")
        so = ctypes.CDLL(str(lib))
        fn = so.deepsc_attention_bwd_cluster_bf16
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
            ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = (so, fn)
    return libs


def timeline(so, blocks):
    """Mean ns of each segment over the blocks, and their mean sum."""
    fn = so.deepsc_timeline
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    fn.restype = ctypes.c_int
    buf = torch.zeros((1 << 16, POINTS), dtype=torch.int64)
    if fn(buf.data_ptr(), buf.numel() * 8):
        raise RuntimeError("reading the timeline failed")
    seg = buf[:blocks].double().mean(dim=0)
    return [round(x, 1) for x in seg.tolist()], seg.sum().item()


# the resident kernel's shapes: the seq-len-128 epoch's 128 x 128, the
# default 31-token decoder's 63 x 64 past a first tile, lengths just past
# 32 and the cross shapes
RESIDENT_SHAPES = (("long_128", 128, 128), ("long_63x64", 63, 64),
                   ("long_33", 33, 33), ("long_31x128", 31, 128),
                   ("long_128x31", 128, 31))


def against_resident(iters):
    """The wrapper at RESIDENT_SHAPES on the resident kernel (its route)
    and on the cluster kernel (the route predicates swapped for the call):
    device ms and the largest error against the plain version, with and
    without dbias."""
    bf16 = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(0)
    routes = (attn.uses_resident, attn.uses_cluster)
    for label, lq, lk in RESIDENT_SHAPES:
        q, k, v, bias = cs.attention_inputs(N, lq, lk, bf16, gen, lq == lk)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
        scale = math.sqrt(DH)
        assert routes[0](bf16, lq, lk, HEADS, DH)
        for dbias in (False, True):
            want = attn.attention_bwd_reference(q, k, v, bias, g, HEADS,
                                                scale, dbias)
            for name in ("resident", "cluster"):
                if name == "cluster":
                    attn.uses_resident = lambda *a: False
                    attn.uses_cluster = lambda *a: True
                try:
                    attn.reset_launches()
                    got = attn.attention_bwd(q, k, v, bias, g, HEADS, scale,
                                             dbias)
                    torch.cuda.synchronize()
                    if attn.cluster_bwd_launches != (name == "cluster"):
                        raise AssertionError(f"{label}: not on {name}")
                    err = cs.max_err(got, want)
                    ms = cs.device_ms(lambda: attn.attention_bwd(
                        q, k, v, bias, g, HEADS, scale, dbias), iters)
                finally:
                    attn.uses_resident, attn.uses_cluster = routes
                print(f"[k2] {label} N={N} {HEADS}x{DH} dbias={dbias} "
                      f"{name}: device_ms {ms!r} max err {err:.3g}",
                      flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--against-resident", action="store_true",
                    help="time the cluster kernel against the resident "
                         "kernel at its shapes, and no variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_bwd_cluster_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    cs.phase_device()
    if args.against_resident:
        against_resident(args.iters)
        return 0
    bf16 = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        for label, lq, lk in SHAPES:
            q, k, v, bias = cs.attention_inputs(N, lq, lk, bf16, gen,
                                                lq == lk)
            g = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
            scale = math.sqrt(DH)
            want = attn.attention_bwd_reference(q, k, v, bias, g, HEADS,
                                                scale, False)
            leaves = [t.detach().requires_grad_(True)
                      for t in cs._sdpa_views(q, k, v)]
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=bias[:, None].to(bf16), scale=1 / scale)
            gh = cs._sdpa_views(g, g, g)[0]
            sdpa = cs.device_ms(lambda: torch.autograd.grad(
                out, leaves, gh, retain_graph=True), args.iters)
            print(f"[k2] {label} N={N} {HEADS}x{DH}: SDPA backward "
                  f"device_ms {sdpa!r}", flush=True)
            for name, (so, fn) in libs.items():
                dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))

                def call():
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             bias.data_ptr(), g.data_ptr(), dq.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(), None, None, N,
                             lq, lk, HEADS, DH, scale,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                try:
                    call()
                except RuntimeError as e:
                    print(f"[k2] {label} {name}: {e}", flush=True)
                    continue
                torch.cuda.synchronize()
                err = cs.max_err([dq, dk, dv], want[:3])
                ms = cs.device_ms(call, args.iters)
                extra = ""
                if name == "timeline":
                    call()
                    torch.cuda.synchronize()
                    size = attn.cluster_size(N, HEADS, lq, lk, torch.cuda
                                             .get_device_properties(0)
                                             .multi_processor_count)
                    seg, total = timeline(so, size * HEADS * N)
                    extra = (f" segments ns {seg} a block's sum ns "
                             f"{total:.0f}")
                print(f"[k2] {label} {name}: device_ms {ms!r} max err "
                      f"{err:.3g}{extra}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
