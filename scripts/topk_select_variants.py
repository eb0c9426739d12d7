#!/usr/bin/env python3
"""The f32 select K6 (csrc/topk_select.cu) as built and with one part of
its logits kernel changed or taken out, timed on one card.

    python3 scripts/topk_select_variants.py [--iters 20]

Each variant is an edited copy of `csrc/topk_select.cu` (each edit a text
replacement that must match the source once), built with the port's nvcc
flags in a temporary directory and called with the wrapper's workspaces
and the vocab splits from the variant's own tiling, on chip_smoke.py's
dyadic inputs, V = 22,234, f32:
- `as_built`;
- `scalar_loads`: each thread's four columns of a chunk read as four
  4-byte loads, even where D is a multiple of 4 (as built: one 16-byte
  load);
- `two_blocks`: the logits kernel compiled for two blocks an SM
  (`__launch_bounds__(256, 2)`);
- `no_exp`: the softmax sums left out of the logits kernel (what they
  cost; its lse is not the plain version's, its indices are).
Prints each variant's device time per call by kernel (torch.profiler: the
logits kernel and the select) and whether its indices equal a stable
descending sort's of the plain logits (exact on these inputs), at the f32
wide beam (N = 64 x 9, D = 200, k = 9), at N = 64 x 4 with D = 200,
k = 16 and D = 512, k = 64, and at k = V (N = 64, D = 128); `torch.topk`
+ `logsumexp`'s device time on the same inputs; and the card's name and
power limit. Needs CUDA.
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
from deepsc_gan_tpu_torch.ops import build  # noqa: E402
from deepsc_gan_tpu_torch.ops import ce_kernel as ce  # noqa: E402
from deepsc_gan_tpu_torch.ops import topk_kernel as topk  # noqa: E402

V = 22234
SHAPES = (("wide_beam", 64 * 9, 200, 9), ("k16_d200", 256, 200, 16),
          ("k64_d512", 256, 512, 64), ("k_vocab", 64, 128, V))
VARIANTS = {
    "as_built": [],
    "scalar_loads": [("""  if ((d & 3) == 0 && row < total && c + 3 < d) {""",
                      """  if (false) {""")],
    "two_blocks": [(
        "__launch_bounds__(kThreads)\ntopk_select_logits_f32_kernel(",
        "__launch_bounds__(kThreads, 2)\ntopk_select_logits_f32_kernel(")],
    "no_exp": [
        ("if (c < v) se += expf(acc[i][j] - mn);",
         "if (c < v) se += acc[i][j] - mn;"),
        ("s[i] = s[i] * expf(m[i] - mn) + se;", "s[i] = s[i] + se;")],
}


def build_variants(tmp: Path) -> dict:
    """Every variant's library, their nvcc processes started together."""
    text = (build.CSRC / f"{topk.KERNEL_SELECT}.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        s = text
        for old, new in edits:
            if s.count(old) != 1:
                raise RuntimeError(f"{name}: an edit does not match the "
                                   f"source once")
            s = s.replace(old, new)
        path, lib = tmp / f"select_{name}.cu", tmp / f"libselect_{name}.so"
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


def variant_call(lib, h, W, b, k):
    """A call of the variant's f32 entry with the wrapper's workspaces and
    the vocab splits from the variant's own tiling."""
    tiling = lib.deepsc_topk_select_tiling_f32
    tiling.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    tiling.restype = ctypes.c_int
    tiles = (ctypes.c_int * 3)()
    if tiling(h.shape[1], tiles):
        raise RuntimeError("tiling failed")
    fn = lib.deepsc_topk_select_f32
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    (n, d), v = h.shape, W.shape[0]
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    splits = ce.vocab_splits(n, v, sms, *tiles)
    vals = torch.empty((n, k), device="cuda")
    idx = torch.empty((n, k), dtype=torch.int32, device="cuda")
    lse = torch.empty(n, device="cuda")
    logits = torch.empty((n, v), device="cuda")
    part = torch.empty((splits, n, 3), device="cuda")
    scratch = torch.empty(1, dtype=torch.int64, device="cuda")

    def call():
        err = fn(h.data_ptr(), W.data_ptr(), b.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), lse.data_ptr(), logits.data_ptr(),
                 part.data_ptr(), scratch.data_ptr(), n, d, v, k, splits,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return vals, idx, lse

    return call


def by_kernel(call, calls=10):
    """Device us a call by kernel name (torch.profiler over `calls`
    calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            m = re.search(r"(\w+)(?:<[\w, ]*>)?\(", e.name)
            name = m.group(1) if m else e.name[:40]
            out[name] = out.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / calls
    return {name: round(us, 2) for name, us in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("topk_select_variants: CUDA is not available", file=sys.stderr)
        return 1
    cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        for label, n, d, k in SHAPES:
            h, W, b = cs.topk_inputs(n, d, k, "dyadic", torch.float32, gen)
            # the plain version's indices (exact logits: a stable sort's)
            want = torch.sort(h @ W.t() + b, dim=1, descending=True,
                              stable=True)[1][:, :k].int()

            def library():
                logits = h @ W.t() + b
                return torch.topk(logits, k), torch.logsumexp(logits, -1)

            print(f"[variants] {label} (N={n} D={d} k={k}) library: "
                  f"{cs.device_ms(library, args.iters):.4f} ms", flush=True)
            for name, lib in libs.items():
                call = variant_call(lib, h, W, b, k)
                got = call()[1]
                same = torch.equal(got, want)
                print(f"[variants] {label} {name}: "
                      f"{cs.device_ms(call, args.iters):.4f} ms, by kernel "
                      f"{by_kernel(call)}, indices equal {same}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
