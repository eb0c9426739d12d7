#!/usr/bin/env python3
"""The f32 wide K2 library's two kernel families on the same shapes: heads
up to 256 wide take its register-held kernels (a lane keeps its 8 elements
of a head), wider heads its chunked ones (the operands of each dot product
read from memory, the output walked in chunks of 256). This times both on
the shapes the register-held kernels take, on one card:

    python3 scripts/wide_chunked_ab.py [--iters 50]

`chunked` is an edited copy of `csrc/attention_wide.cu` (the Dh test of
the launcher replaced, so every head takes the chunked kernels; the edit
is a text replacement that must match the source once), built with the
port's nvcc flags beside the source as it is (`as_is`) in a temporary
directory and called through its C interface. Shapes: chip_smoke.py's
WIDE_PATH (the widened train path's encoder at 8 heads of 64, its decoder
at 8 heads of 25) and WIDE_HEADS (8 heads of 24, 64, 128, 32 heads of 16,
Lq = Lk = 31), N = 64, f32, on chip_smoke.py's inputs. Prints each
variant's device time per call (`chip_smoke.device_ms`: the calls queued
behind a spin of the device) of the backward without and with dbias, the
ratios, and whether the two variants' outputs are bitwise equal, with the
card's name and power limit. The library holds f32 alone (bf16 heads are
csrc/attention_wide_mma.cu's and csrc/attention_chunked.cu's, on the
tensor cores) and no forward (the f32 forward at these shapes is
csrc/attention_tiled.cu's). Needs CUDA.
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
from deepsc_gan_tpu_torch.ops import attention_kernel as attn  # noqa: E402
from deepsc_gan_tpu_torch.ops import build  # noqa: E402

EDITS = [("  const bool chunked = sh.dh > kMaxDh;",
          "  const bool chunked = true;")]
VARIANTS = {"as_is": [], "chunked": EDITS}


def build_variants(tmp: Path) -> dict:
    """Both variants' libraries, their nvcc processes started together."""
    text = (build.CSRC / f"{attn.KERNEL_WIDE}.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        s = text
        for old, new in edits:
            if s.count(old) != 1:
                raise RuntimeError(f"{name}: the edit does not match the "
                                   f"source once")
            s = s.replace(old, new)
        path, lib = tmp / f"wide_{name}.cu", tmp / f"libwide_{name}.so"
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
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def stream():
    return torch.cuda.current_stream().cuda_stream


def wide_rows(libs, gen, iters):
    """The wide f32 K2 at each head shape up to 256 wide, as it is and
    through the chunked kernels."""
    shapes = list(cs.WIDE_PATH) + [(f"wide_{h}x{dh}", h, dh, 31, 31)
                                   for h, dh in cs.WIDE_HEADS]
    n = 64
    dtype, suffix = torch.float32, "f32"
    for label, heads, dh, lq, lk in shapes:
        q, k, v, bias = cs.attention_inputs(n, lq, lk, dtype, gen,
                                            lq == lk, heads, dh)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        stats = torch.empty((n, heads, lq, 4), dtype=torch.float32,
                            device="cuda")
        scale = dh ** 0.5
        outs, times = {}, {}
        for name in VARIANTS:
            bwd = getattr(libs[name], f"deepsc_attention_wide_bwd_{suffix}")
            bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                            + [ctypes.c_double, ctypes.c_void_p])
            bwd.restype = ctypes.c_int
            grads = [torch.empty_like(t) for t in (q, k, v, bias)]

            def call_bwd(dbias, bwd=bwd, grads=grads, name=name):
                err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          bias.data_ptr(), g.data_ptr(),
                          *(t.data_ptr() for t in grads[:3]),
                          grads[3].data_ptr() if dbias else None,
                          stats.data_ptr(), n, lq, lk, heads, dh, scale,
                          stream())
                if err:
                    raise RuntimeError(f"wide K2 {name}: CUDA error "
                                       f"{err}")

            call_bwd(True)
            torch.cuda.synchronize()
            outs[name] = [t.clone() for t in grads]
            times[name] = [
                cs.device_ms(lambda f=call_bwd: f(False), iters),
                cs.device_ms(lambda f=call_bwd: f(True), iters)]
        same = all(torch.equal(a, b) for a, b in zip(*outs.values()))
        for name, (b, bd) in times.items():
            print(f"[wide] {name:7s} {suffix} {label:19s} "
                  f"({heads} x {dh}, {lq} x {lk}): device_ms K2 {b!r}, "
                  f"K2+dbias {bd!r}", flush=True)
        ratio = [c / a if a else None
                 for c, a in zip(times["chunked"], times["as_is"])]
        ref = attn.attention_bwd_reference(q, k, v, bias, g, heads, scale)
        err = max((a.float() - r.float()).abs().max().item()
                  for a, r in zip(outs["as_is"][:3], ref[:3]))
        print(f"[wide] {suffix} {label}: chunked / as_is K2 "
              f"{ratio[0]:.3f}, K2+dbias {ratio[1]:.3f}; outputs bitwise "
              f"equal {same}; dq, dk, dv max err vs plain {err:.3g}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_chunked_ab: CUDA is not available", file=sys.stderr)
        return 1
    cs.phase_device()
    gen = torch.Generator("cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        wide_rows(build_variants(Path(tmp)), gen, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
