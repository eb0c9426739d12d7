#!/usr/bin/env python3
"""The port's vocab cross-entropy kernels K3 and K4 of two checkouts, timed
in turns on one card.

    python3 scripts/ce_kernels_ab.py OLD NEW [--turns ABBA] [--iters 50]

OLD and NEW are roots of checkouts of the repo (for instance a parent commit
unpacked with `git archive <commit> chip_smoke.py deepsc_gan_tpu_torch` into
a directory that .gitignore lists, and `.`). Turn A runs OLD, turn B runs
NEW, each in a process of its own from its checkout's root, which builds
that checkout's kernels and runs its own `chip_smoke.ce_cases`: K3 and K4
against their plain versions at the training path's shape (N = 1,984,
D = 128, V = 22,234) in bf16 and f32, with the time per call between CUDA
events, the host's enqueue time, the plain version's time and the library
call's. Each turn then takes the device time per call of every kernel the
two bf16 wrappers launch, from torch.profiler over 20 calls. Prints every
row with its checkout and turn, then the median of each number by
checkout, and the card's name and power limit. Needs CUDA; imports nothing
of either checkout itself.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

N, D, V = 1984, 128, 22234

TURN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from deepsc_gan_tpu_torch.ops import build
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

cs.phase_device()
build.build([ce.KERNEL_FWD, ce.KERNEL_BWD])
n, d, v, iters = {n}, {d}, {v}, {iters}
for dtype in (torch.bfloat16, torch.float32):
    gen = torch.Generator("cuda").manual_seed(0)
    for row in cs.ce_cases(dtype, gen, iters, n, d, v):
        print("ROW " + json.dumps(row), flush=True)
gen = torch.Generator("cuda").manual_seed(1)
h = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
W = (0.1 * torch.randn((v, d), generator=gen, device="cuda")).to(h.dtype)
b = 0.1 * torch.randn(v, generator=gen, device="cuda")
labels = torch.randint(0, v, (n,), generator=gen, device="cuda")
g = torch.rand(n, generator=gen, device="cuda")
lse = ce.ce_fwd(h, W, b, labels)[1]
calls = {{ce.KERNEL_FWD: lambda: ce.ce_fwd(h, W, b, labels),
          ce.KERNEL_BWD: lambda: ce.ce_bwd(h, W, b, labels, lse, g)}}
for kernel, call in calls.items():
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    by_name = {{}}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            us = (e.time_range.end - e.time_range.start) / 20
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    print("DEVICE " + json.dumps({{"kernel": kernel, "dtype": "bfloat16",
                                  "device_us": sum(by_name.values()),
                                  "by_name": by_name}}), flush=True)
"""


def run_turn(root: Path, iters: int) -> list:
    """One checkout's rows: ("kernel", dict) for each ROW and DEVICE line."""
    code = TURN.format(n=N, d=D, v=V, iters=iters)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {root} failed (exit {proc.returncode}):"
                           f"\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    out = []
    for line in proc.stdout.splitlines():
        if line.startswith("[device]"):
            print(f"  {line}")
        for tag in ("ROW ", "DEVICE "):
            if line.startswith(tag):
                out.append((tag.strip(), json.loads(line[len(tag):])))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--turns", default="ABBA")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    roots = {"A": args.old.resolve(), "B": args.new.resolve()}
    print(f"A = {roots['A']}\nB = {roots['B']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}")
    seen = {}
    for i, turn in enumerate(args.turns):
        for tag, row in run_turn(roots[turn], args.iters):
            print(f"[turn {i} {turn}] {tag} {json.dumps(row)}")
            if tag == "ROW":
                key = (turn, row["kernel"], row["dtype"])
                for field in ("ms", "host_enqueue_ms", "plain_ms",
                              "library_ms", "device_ms"):
                    if field in row:
                        seen.setdefault(key + (field,), []).append(
                            row[field])
            else:
                key = (turn, row["kernel"], row["dtype"], "device_us")
                seen.setdefault(key, []).append(row["device_us"])
    print("medians by checkout:")
    for key in sorted(seen):
        vals = seen[key]
        print(f"  {' '.join(key)}: {statistics.median(vals)!r} "
              f"(of {len(vals)}: {vals})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
