#!/usr/bin/env python3
"""K4's softmax-part gate (chip_smoke.py `SOFTMAX_TOL`, bf16 2e-3) against
an f64 evaluation: which side of a reading near the gate is off, the
kernel or its plain version.

    python3 scripts/ce_softmax_gate.py [--seeds 8]

On chip_smoke.py's bf16 CE inputs (`ce_inputs`: N = 1,984, V = 22,234)
from each of `--seeds` generators, at D = 128 (the tuned K4), 200, 512 and
640 (the tensor-core wide K4), the full backward and the dh-only mode:
the softmax-part error (`chip_smoke.softmax_part_err`) of the kernel
against the plain version (`ce_kernel.ce_bwd_reference`), of the kernel
against an f64 evaluation of K4's function (P from f64 logits, rounded to
bf16 through f32), and of the plain version against that evaluation; and
the same for the plain version with P formed in f32 (`f32_p_reference`,
the plain version before it formed P from f64 logits). The largest of
each over the seeds, and the card's name and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from deepsc_gan_tpu_torch.ops import ce_kernel as ce  # noqa: E402

N, V = 1984, 22234
WIDTHS = (128, 200, 512, 640)


def f64_evaluation(h, W, b, labels, lse, g, softmax_only=False,
                   dh_only=False):
    """K4's function in f64: P from f64 logits (less the given lse), the
    label term, rounded to bf16 through f32 as the kernels round it; the
    products and db in f64."""
    hh, ww = h.double(), W.double()
    p = torch.exp(hh @ ww.t() + b.double() - lse.double()[:, None]) \
        * g.double()[:, None]
    if not softmax_only:
        p[torch.arange(h.shape[0]), labels.long()] -= g.double()
    pc = p.float().to(torch.bfloat16).double()
    if dh_only:
        return pc @ ww, None, None
    return pc @ ww, pc.t() @ hh, p.sum(0)


def f32_p_reference(h, W, b, labels, lse, g, softmax_only=False,
                    dh_only=False):
    """The plain version with P formed in f32 (f32 logits and exp), then
    rounded to bf16."""
    hf, wf = h.float(), W.float()
    p = torch.exp(hf @ wf.t() + b - lse[:, None]) * g[:, None]
    if not softmax_only:
        p[torch.arange(h.shape[0]), labels.long()] -= g
    pc = p.to(torch.bfloat16).float()
    if dh_only:
        return pc @ wf, None, None
    return pc @ wf, pc.t() @ hf, p.sum(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ce_softmax_gate: CUDA is not available", file=sys.stderr)
        return 1
    cs.phase_device()
    worst = {}
    for seed in range(args.seeds):
        gen = torch.Generator("cuda").manual_seed(seed)
        for d in WIDTHS:
            h, W, b, labels, g = cs.ce_inputs(torch.bfloat16, gen, N, d, V)
            lse = ce.ce_fwd_reference(h, W, b, labels)[1]
            for dh_only in (False, True):
                outs = 1 if dh_only else 3
                x = (h, W, b, labels, lse, g)
                kernel = ce.ce_bwd(*x, dh_only=dh_only)[:outs]
                plain = ce.ce_bwd_reference(*x, dh_only=dh_only)[:outs]
                old = f32_p_reference(*x, dh_only=dh_only)[:outs]
                exact = f64_evaluation(*x, dh_only=dh_only)[:outs]
                part = f64_evaluation(*x, softmax_only=True,
                                      dh_only=dh_only)[:outs]
                row = {
                    "kernel/plain": cs.softmax_part_err(kernel, plain, part),
                    "kernel/f64": cs.softmax_part_err(kernel, exact, part),
                    "plain/f64": cs.softmax_part_err(plain, exact, part),
                    "kernel/f32p_plain": cs.softmax_part_err(kernel, old,
                                                             part),
                    "f32p_plain/f64": cs.softmax_part_err(old, exact, part)}
                mode = "dh-only" if dh_only else "full"
                print(f"[gate] seed {seed} D={d} {mode}: " + ", ".join(
                    f"{k} {v:.3e}" for k, v in row.items()), flush=True)
                for k, v in row.items():
                    key = (d, mode, k)
                    worst[key] = max(worst.get(key, 0.0), v)
    for (d, mode, k), v in sorted(worst.items()):
        print(f"[gate] worst over {args.seeds} seeds, D={d} {mode}, {k}: "
              f"{v:.3e} (gate {cs.SOFTMAX_TOL[torch.bfloat16]})")
    print(f"[gate] card: {cs.CARD['smi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
