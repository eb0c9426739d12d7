#!/usr/bin/env python3
"""The bf16 tensor-core wide K6 (csrc/topk_wide_mma.cu) as built and with
one part changed or taken out, timed on one card.

    python3 scripts/topk_wide_mma_variants.py [--iters 20]

Each variant is an edited copy of `csrc/topk_wide_mma.cu` (each edit a
text replacement that must match the source once), built with the port's
nvcc flags in a temporary directory and called with the wrapper's
workspaces and the vocab splits from the variant's own tiling, on
chip_smoke.py's dyadic inputs, V = 22,234, bf16:
- `as_built`;
- `no_selection`: the tile loop without the selection (no bound, no
  filter, no merge): what the logits and the softmax sums cost alone (its
  indices are not the plain version's);
- `no_shared_threshold`: each split filters by its own list's k-th key
  only (the rows' slot neither read nor raised);
- `buffer_16`: 16 candidate keys a row a round instead of 32;
- `bisect_6`: the first tile's bound from 6 halvings of the row's range
  instead of 12;
- `buffer_64`: 64 candidate keys a row a round instead of 32.
Past k = 64 each variant runs the long path (its lists of 16 in the
partial kernel, the threshold, the emission, the select, the fallback),
with the wrapper's plan (`topk.long_plan` on the variant's tilings). Each
variant's device time is also split by kernel (torch.profiler).
Prints each variant's device time per call (`chip_smoke.device_ms`, the
partial kernel and the split merge) and whether its indices equal the
plain version's, at the wide beam (N = 64 x 9, D = 200, k = 9), at N = 64 x
4 and D = 200 with k = 16, 64, 100 and 256, at D = 512 with k = 64 and 256,
at the beam sweep's rows (N = 19 x 64 x 9, D = 200, k = 9) and at the
beam-100 path's (N = 64 x 100, D = 128, k = 100); `torch.topk` +
`logsumexp`'s device time on the same inputs; and the card's name and
power limit. Needs CUDA.
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
from deepsc_gan_tpu_torch.ops import topk_kernel as topk  # noqa: E402

V = 22234
SHAPES = (("wide_beam", 64 * 9, 200, 9), ("k16_d200", 256, 200, 16),
          ("k64_d200", 256, 200, 64), ("k64_d512", 256, 512, 64),
          ("beam_sweep", 19 * 64 * 9, 200, 9), ("k100_d200", 256, 200, 100),
          ("k256_d200", 256, 200, 256), ("k256_d512", 256, 512, 256),
          ("beam100", 64 * 100, 128, 100))
VARIANTS = {
    "as_built": [],
    "no_selection": [
        ("      if (__any_sync(0xffffffffu, kth[h] == 0)) {",
         "      if (k < 0) {"),
        ("          if ((x > tv || (ties && x == tv)) && x >= lo)",
         "          if (k < 0)"),
        ("    if (__any_sync(0xffffffffu, (mask[0] | mask[1]) != 0)) {",
         "    if (k < 0) {")],
    "no_shared_threshold": [
        ("    for (int h = 0; h < 2; ++h) shared[h] = slot[h] ? "
         "__ldcg(slot[h]) : 0;",
         "    for (int h = 0; h < 2; ++h) shared[h] = 0;"),
        ("        atomicMax(slot[h], kth[h]);", "        ;")],
    "buffer_16": [("constexpr int kBuf = 32;", "constexpr int kBuf = 16;")],
    "bisect_6": [("constexpr int kBisect = 12;",
                  "constexpr int kBisect = 6;")],
    "buffer_64": [("constexpr int kBuf = 32;", "constexpr int kBuf = 64;")],
}


def build_variants(tmp: Path) -> dict:
    """Each variant's (launch, tiling, library) functions, their nvcc
    processes started together."""
    text = (build.CSRC / f"{topk.KERNEL_WIDE_MMA}.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        s = text
        for old, new in edits:
            if s.count(old) != 1:
                raise RuntimeError(f"{name}: an edit does not match the "
                                   f"source once: {old!r}")
            s = s.replace(old, new)
        path, lib = tmp / f"k6_{name}.cu", tmp / f"libk6_{name}.so"
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
        so = ctypes.CDLL(str(lib))
        fn = so.deepsc_topk_wide_mma_bf16
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        tiling = so.deepsc_topk_wide_mma_tiling_bf16
        tiling.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        tiling.restype = ctypes.c_int
        fns[name] = (fn, tiling, so)
    return fns


def long_call(so, tiling, h, W, b, k):
    """A call of a variant's long path on checked bf16 operands, as the
    wrapper makes it; -> (call, its (vals, idx, lse), the partial
    kernel's splits)."""
    (n, d), v = h.shape, W.shape[0]
    out, emit = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    etiling = so.deepsc_topk_wide_mma_emit_tiling_bf16
    etiling.argtypes = [ctypes.POINTER(ctypes.c_int)]
    etiling.restype = ctypes.c_int
    if tiling(topk.SELECT_LIST, out) or etiling(emit):
        raise RuntimeError("tiling failed")
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    plan = topk.long_plan(n, v, k, sms, tuple(out), tuple(emit))
    fn = so.deepsc_topk_wide_mma_long_bf16
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = h.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    work = [torch.empty((n, plan.splits, topk.SELECT_LIST),
                        dtype=torch.int64, device=dev),
            torch.empty((plan.splits, n, 3), dtype=torch.float32,
                        device=dev),
            torch.empty((n, 2), dtype=torch.int64, device=dev),
            torch.empty((n, plan.cap), dtype=torch.int64, device=dev),
            torch.empty(n + 1, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev)]

    def call():
        err = fn(h.data_ptr(), W.data_ptr(), b.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), lse.data_ptr(),
                 *(t.data_ptr() for t in work), n, d, v, k, plan.splits,
                 plan.emit_splits, plan.cap,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    return call, (vals, idx, lse), plan.splits


def variant_call(fn, tiling, h, W, b, k):
    """A call of the variant on checked bf16 operands, as the wrapper makes
    it; -> (call, its (vals, idx, lse), splits)."""
    (n, d), v = h.shape, W.shape[0]
    out = (ctypes.c_int * 3)()
    if tiling(k, out):
        raise RuntimeError("tiling failed")
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    splits = ce.vocab_splits(n, v, sms, *tuple(out))
    dev = h.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    part_key = torch.empty((n, splits, k), dtype=torch.int64, device=dev)
    part_ms = torch.empty((splits, n, 3), dtype=torch.float32, device=dev)
    row_kth = torch.empty(n, dtype=torch.int64, device=dev)

    def call():
        row_kth.zero_()
        err = fn(h.data_ptr(), W.data_ptr(), b.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), lse.data_ptr(), part_key.data_ptr(),
                 part_ms.data_ptr(), row_kth.data_ptr(), n, d, v, k, splits,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    return call, (vals, idx, lse), splits


def by_kernel(call, calls=10):
    """Device microseconds a call by kernel name (torch.profiler over
    `calls` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            name = cs._kernel_name(e.name) if "(" in e.name else e.name
            us = (e.time_range.end - e.time_range.start) / calls
            out[name] = round(out.get(name, 0.0) + us, 2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("topk_wide_mma_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    cs.phase_device()
    bf16 = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp))
        for label, n, d, k in SHAPES:
            h = cs.dyadic((n, d), 8, gen, bf16)
            W = cs.dyadic((V, d), 2, gen, bf16)
            b = cs.dyadic((V,), 8, gen, torch.float32)
            want = topk.topk_logits_reference(h, W, b, k)

            def library():
                logits = (h @ W.t()).float() + b
                return torch.topk(logits, k), torch.logsumexp(logits, -1)

            print(f"[k6] {label} N={n} D={d} k={k} library device_ms "
                  f"{cs.device_ms(library, args.iters)!r}", flush=True)
            for name, (fn, tiling, so) in fns.items():
                try:
                    call, got, splits = (
                        long_call(so, tiling, h, W, b, k)
                        if k > topk.K_SHORT else
                        variant_call(fn, tiling, h, W, b, k))
                    call()
                except RuntimeError as e:
                    print(f"[k6] {label} {name}: {e}", flush=True)
                    continue
                torch.cuda.synchronize()
                print(f"[k6] {label} {name}: splits {splits} device_ms "
                      f"{cs.device_ms(call, args.iters)!r} indices equal "
                      f"{torch.equal(got[1], want[1])}; by kernel (us) "
                      f"{by_kernel(call)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
