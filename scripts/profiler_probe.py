#!/usr/bin/env python3
"""How often torch.profiler records none of a profiled call's device
kernels on this card, by profiler activities.

    python3 scripts/profiler_probe.py [--profiles 200] [--rounds 2]

Builds every kernel library of csrc/, then profiles one bf16 K6 call on
its long path (N = 256, D = 512, V = 22,234, k = 100, every logit equal
to a bias with six equal maxima: five device kernels) `--profiles` times
in each mode, `--rounds` times over:
- `cuda`: CUDA activity only, as the card tests' `_ran` profiles;
- `cpu+cuda`: CPU and CUDA activities;
- `cuda+spin`: CUDA activity, a short device spin before the call, as
  chip_smoke.py's `ran_kernels` profiles.
Prints, for each mode and round, the profiles that recorded none of the
call's kernels and those that recorded some but not all five, with the
first few blind profiles' device names and event counts; and the card's
name and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from deepsc_gan_tpu_torch.ops import build  # noqa: E402
from deepsc_gan_tpu_torch.ops import topk_kernel as topk  # noqa: E402

N, D, V, K = 256, 512, 22234, 100
KERNELS = 5


def profiled(call, activities, spin):
    """(the device kernel names of one profile of `call`, its events)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if spin:
            torch.cuda._sleep(1000)
        call()
        torch.cuda.synchronize()
    events = list(prof.events())
    return {e.name for e in events
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}, len(events)


def main(argv=None) -> int:
    from torch.profiler import ProfilerActivity

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profiles", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    cs.phase_device()
    build.build(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    dev = torch.device("cuda")
    h = torch.zeros((N, D), device=dev, dtype=torch.bfloat16)
    W = torch.zeros((V, D), device=dev, dtype=torch.bfloat16)
    b = torch.zeros(V, device=dev)
    b[torch.arange(9, 9 + 7 * 6, 7)] = 1.0

    def call():
        return topk.topk_logits(h, W, b, K)

    call()
    modes = {"cuda": ([ProfilerActivity.CUDA], False),
             "cpu+cuda": ([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                          False),
             "cuda+spin": ([ProfilerActivity.CUDA], True)}
    for rnd in range(args.rounds):
        for name, (activities, spin) in modes.items():
            blind, partial, t0 = 0, 0, time.perf_counter()
            for i in range(args.profiles):
                names, events = profiled(call, activities, spin)
                ours = [x for x in names if "topk" in x]
                if not ours:
                    blind += 1
                    if blind <= 3:
                        print(f"  {name} profile {i}: none of the call's "
                              f"kernels; {len(names)} device names, "
                              f"{events} events", flush=True)
                elif len(ours) != KERNELS:
                    partial += 1
            print(f"[probe] round {rnd} {name}: {blind} of {args.profiles} "
                  f"profiles without the call's kernels, {partial} with "
                  f"some, {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
