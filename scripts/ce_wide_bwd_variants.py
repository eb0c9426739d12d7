#!/usr/bin/env python3
"""What bounds the bf16 wide K4 (csrc/ce_wide_bwd.cu): the kernels built as
they are and with one part taken out, timed on one card.

    python3 scripts/ce_wide_bwd_variants.py [--iters 20]
        [--variants as_is,no_exchange,...]

Every variant is an edited copy of `csrc/ce_wide_bwd.cu` (each edit a text
replacement that must match the source once), built with the port's nvcc
flags in a temporary directory and called through the port's wrapper
(`ce_kernel.ce_bwd`, its bound launch function replaced by the variant's)
on chip_smoke.py's inputs, N = 1,984, V = 22,234, bf16. Variants:
- `as_is`;
- `no_exchange`: no sum of the partial logits (no shared-memory slot, no
  barrier of the block or the cluster; each warpgroup uses its own
  partial);
- `no_exp`: P without its exponential;
- `exact_exp`: P with the plain version's roundings and expf (the logit,
  less lse, each rounded) in place of ex2.approx of the log2(e)-scaled
  logit less lse;
- `one_chain`: each warpgroup's partial logits as one tensor-core chain
  over all its k-steps, waited for with the products, in place of f32
  sums of each slab's tensor-core sum;
- `no_products`: no Pc . B_t products;
- `no_logits`: no partial logits (products on whatever the registers
  hold);
- `timeline`: as is, with the cycles of each phase of a tile (`PHASES`)
  read by one thread of each warpgroup of the grid's first block and
  printed per tile, for the dh kernel of the dh-only mode.
Only `as_is`, `exact_exp` and `one_chain` compute K4; the others are
timings. Prints each variant's device time per call
(`chip_smoke.device_ms`) of the full backward at D = 200, 512 and 640 and
of the dh-only mode at D = 640, on inputs from the first of SEEDS
generators; for the three that compute K4, on the inputs of each of the
SEEDS generators, their largest error against the plain version and, on
the softmax part (chip_smoke.py's gates), their error against the plain
version and against an f64 evaluation of the function, and the plain
version's against the f64 one; and the card's name and power limit.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from deepsc_gan_tpu_torch.ops import build  # noqa: E402
from deepsc_gan_tpu_torch.ops import ce_kernel as ce  # noqa: E402

N, V = 1984, 22234
SEEDS = 8
# the partial logits as f32 sums of the slabs' tensor-core sums (as the
# kernels form them), and as one tensor-core chain over every k-step
LOGITS_SLABS = ("template <int NC>\n"
                "__device__ __forceinline__ void form_logits(")
LOGITS_CHAIN = """template <int NC>
__device__ __forceinline__ void form_logits(float (&p)[16], uint32_t a,
                                            uint32_t b) {
  wg::fence_regs(p);
#pragma unroll
  for (int kk = 0; kk < 4 * NC; ++kk)
    mma_ss_n32(p, wg::desc_k(a, wg::kRows, kk), wg::desc_k(b, kTile, kk),
               kk > 0);
  wg::commit();
  wg::wait_all();
  wg::fence_regs(p);
}

template <int NC>
__device__ __forceinline__ void form_logits_slabs("""
# P as the kernels form it (`prob`)
PROB = ("  return wg::exp2_approx(fmaf(s + b, wg::kLog2e, -lse * "
        "wg::kLog2e)) * g;")
VARIANTS = {
    "as_is": [],
    "no_exchange": [(
        "  const int buf = it & 1;\n",
        "  for (int i = 0; i < 16; ++i) s[i] = p[i];\n"
        "  if (ranks > 0) return;\n"
        "  const int buf = it & 1;\n")],
    "no_exp": [(PROB, "  return fmaf(s + b, wg::kLog2e, -lse * wg::kLog2e) "
                      "* g;")],
    "exact_exp": [(
        PROB, "  return __fmul_rn(expf(__fsub_rn(__fadd_rn(s, b), lse)), "
              "g);")],
    "one_chain": [(LOGITS_SLABS, LOGITS_CHAIN)],
    "no_products": [(
        "      wg::mma_rs_n64(acc[s], a + 4 * kk, wg::desc_mn(b, kTile, s, "
        "kk),\n                     kk > 0 || !first);", "      ;")],
    "no_logits": [(
        "      mma_ss_n32(u, wg::desc_k(a, wg::kRows, 4 * sl + k4),\n"
        "                 wg::desc_k(b, kTile, 4 * sl + k4), k4 > 0);",
        "      ;")],
    # as_is, with clock64() read at each phase of a tile by one thread of
    # each warpgroup of the grid's first block: the cycles of each phase,
    # summed over the tiles, into a device array that `deepsc_k4_phases`
    # copies out (and zeroes)
    "timeline": [
        ("namespace {\n\nconstexpr int kWarpgroups",
         "__device__ long long g_phase[2][8];\n\n"
         "namespace {\n\nconstexpr int kWarpgroups"),
        ("  const int nx = it + 1 < w.count ? it + 1 : it;\n"
         "  if (nx != it) w.wait(nx);\n",
         "  const long long c0 = clock64();\n"
         "  const int nx = it + 1 < w.count ? it + 1 : it;\n"
         "  if (nx != it) w.wait(nx);\n"
         "  const long long c1 = clock64();\n"
         "  const long long c2 = c1;\n"),
        ("  uint32_t a[8];\n  to_a(s, a);\n  wg::fence_regs(a);\n",
         "  const long long c3 = clock64();\n"
         "  uint32_t a[8];\n  to_a(s, a);\n  wg::fence_regs(a);\n"
         "  const long long c4 = clock64();\n"),
        ("  w.refill<kDW>(it);\n}",
         "  const long long c5 = clock64();\n"
         "  w.refill<kDW>(it);\n  const long long c6 = clock64();\n"
         "  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&\n"
         "      threadIdx.x % wg::kThreads == 0) {\n"
         "    long long* ph = g_phase[threadIdx.x / wg::kThreads];\n"
         "    ph[0] += c1 - c0; ph[1] += c2 - c1; ph[2] += c3 - c2;\n"
         "    ph[3] += c4 - c3; ph[4] += c5 - c4; ph[5] += c6 - c5;\n"
         "    ph[6] += 1;\n  }\n}"),
        ("}  // extern \"C\"\n",
         "int deepsc_k4_phases(long long* out) {\n"
         "  int err = (int)cudaMemcpyFromSymbol(out, g_phase, "
         "sizeof(g_phase));\n"
         "  if (err) return err;\n"
         "  static const long long zero[2][8] = {};\n"
         "  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n"
         "}\n\n}  // extern \"C\"\n")],
}
PHASES = ("wait for the next stage", "(none)", "the exchange",
          "P and its A operand", "the products' and logits' wait",
          "refill (block barrier)")


def build_variants(tmp: Path, names) -> dict:
    """Each variant's library, their nvcc processes started together."""
    text = (build.CSRC / f"{ce.KERNEL_WIDE_BWD}.cu").read_text()
    jobs = {}
    for name in names:
        s = text
        for old, new in VARIANTS[name]:
            if s.count(old) != 1:
                raise RuntimeError(f"{name}: an edit does not match the "
                                   f"source once: {old!r}")
            s = s.replace(old, new)
        path, lib = tmp / f"k4_{name}.cu", tmp / f"libk4_{name}.so"
        path.write_text(s)
        cmd = build.nvcc_command(path, lib, build.find_nvcc())
        cmd[1:1] = ["-I", str(build.CSRC)]
        jobs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).deepsc_ce_wide_bwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
        if name == "timeline":
            phases = ctypes.CDLL(str(lib)).deepsc_k4_phases
            phases.argtypes = [ctypes.c_void_p]
            phases.restype = ctypes.c_int
            fns["timeline_phases"] = phases
    return fns


def timeline(fns, inputs):
    """The dh kernel's cycles a tile by phase, one dh-only call each at
    D = 200, 512 and 640, for each warpgroup of the first block."""
    out = (ctypes.c_longlong * 16)()
    for d in (200, 512, 640):
        fns["timeline_phases"](out)  # zero
        ce.ce_bwd(*inputs[d], dh_only=True)
        torch.cuda.synchronize()
        if fns["timeline_phases"](out):
            raise RuntimeError("reading the phases failed")
        for wgi in range(2):
            ph = out[8 * wgi:8 * wgi + 8]
            tiles = max(ph[6], 1)
            parts = ", ".join(f"{name} {ph[k] / tiles:.0f}"
                              for k, name in enumerate(PHASES))
            print(f"[k4] timeline D={d} warpgroup {wgi}: {tiles} tiles; "
                  f"cycles a tile: {parts}", flush=True)


def exact(x, dh_only):
    """K4's function on the inputs x evaluated in f64 (P from f64 logits,
    rounded to bf16 through f32 as the plain version rounds it)."""
    h, W, b, labels, lse, g = x
    hh, ww = h.double(), W.double()
    p = torch.exp(hh @ ww.t() + b.double() - lse.double()[:, None]) \
        * g.double()[:, None]
    p[torch.arange(h.shape[0]), labels.long()] -= g.double()
    pc = p.float().to(torch.bfloat16).double()
    out = (pc @ ww, pc.t() @ hh, p.sum(0))
    return out[:1] if dh_only else out


def gates(name, d, dh_only, inputs):
    """For a variant that computes K4, over SEEDS inputs: its largest error
    against the plain version (relative to the largest reference value),
    and on the softmax part (relative to that part's largest value, the
    gate of chip_smoke.py) its error against the plain version, against an
    f64 evaluation (`exact`), and the plain version's against f64."""
    if name not in ("as_is", "exact_exp", "one_chain"):
        return ""
    errs, parts = [], []
    outs = 1 if dh_only else 3
    for seed in range(SEEDS):
        x = inputs[d, seed]
        got = ce.ce_bwd(*x, dh_only=dh_only)[:outs]
        want = ce.ce_bwd_reference(*x, dh_only=dh_only)[:outs]
        part = ce.ce_bwd_reference(*x, softmax_only=True,
                                   dh_only=dh_only)[:outs]
        f64 = exact(x, dh_only)
        errs.append(cs.max_err(got, want, relative=True))
        parts.append("/".join(f"{cs.softmax_part_err(a, r, part):.3g}"
                              for a, r in ((got, want), (got, f64),
                                           (want, f64))))
    return (f"; max err (relative) {max(errs):.3g}; softmax part, "
            f"kernel/plain, kernel/f64, plain/f64: {', '.join(parts)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if not set(names) <= set(VARIANTS):
        ap.error(f"--variants takes {', '.join(VARIANTS)}")
    if not torch.cuda.is_available():
        print("ce_wide_bwd_variants: CUDA is not available", file=sys.stderr)
        return 1
    cs.phase_device()
    bf16 = torch.bfloat16
    # chip_smoke.py's inputs at each width, from SEEDS generators (the
    # gates are held on each, the times taken on the first)
    inputs = {}
    for seed in range(SEEDS):
        gen = torch.Generator("cuda").manual_seed(seed)
        for d in (200, 512, 640):
            h, W, b, labels, g = cs.ce_inputs(bf16, gen, N, d, V)
            inputs[d, seed] = (h, W, b, labels,
                               ce.ce_fwd_reference(h, W, b, labels)[1], g)
    key = (ce.KERNEL_WIDE_BWD, bf16)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp), names)
        if "timeline" in names:
            ce._BOUND[key] = fns["timeline"]
            timeline(fns, {d: inputs[d, 0] for d in (200, 512, 640)})
        for name in names:
            if name == "timeline":
                continue
            ce._BOUND[key] = fns[name]
            for d, dh_only in ((200, False), (512, False), (640, False),
                               (640, True)):
                x = inputs[d, 0]
                ms = cs.device_ms(lambda x=x, o=dh_only: ce.ce_bwd(
                    *x, dh_only=o), args.iters)
                mode = "dh-only" if dh_only else "full"
                print(f"[k4] {name:12s} D={d} {mode:7s} device_ms {ms!r}"
                      f"{gates(name, d, dh_only, inputs)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
