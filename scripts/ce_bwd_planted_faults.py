#!/usr/bin/env python3
"""What chip_smoke.py's two K4 gates read on the sound kernel and on K4
built with a fault planted in its bf16 source.

    python3 scripts/ce_bwd_planted_faults.py [--seeds 0 1]

Run from the root of a checkout. For each fault, a copy of
`deepsc_gan_tpu_torch` in a temporary directory gets one edit of
`csrc/ce_bwd.cu`; a process of its own builds that copy's K4 and reads,
at the training path's shape (N = 1,984, D = 128, V = 22,234) on
chip_smoke's inputs (`chip_smoke.ce_inputs`, one generator seed each), the
gates chip_smoke holds K4 to: the error over the largest reference value
(`TOL`) and over the largest value of the reference's softmax part
(`SOFTMAX_TOL`). The faults, each in both bf16 kernels' epilogues:

- none: the sources as they are (also in f32);
- dw_no_softmax / dh_no_softmax: P without exp(S + b - lse) g in the dW
  and db kernel / in the dh kernel;
- dw_softmax_x1.01 / dh_softmax_x1.01: that term scaled by 1.01.

Prints one JSON line per (fault, dtype, seed), with whether each gate
caught it, and the card's name and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DW = "x = wg::exp2_approx(fmaf(x, wg::kLog2e, bias2[i] - lse2[j])) * g[j];"
DH = "float y = wg::exp2_approx("
FAULTS = {
    "none": None,
    "dw_no_softmax": (DW, "x = 0.f;"),
    "dw_softmax_x1.01": (DW, "x = 1.01f * " + DW[4:]),
    "dh_no_softmax": (DH, "float y = 0.f * wg::exp2_approx("),
    "dh_softmax_x1.01": (DH, "float y = 1.01f * wg::exp2_approx("),
}

READ = r"""
import json, sys, torch
sys.path.append({root!r})
import chip_smoke as cs
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
torch.backends.cuda.matmul.allow_tf32 = False
n, d, v = 1984, 128, 22234
for dtype in {dtypes}:
    for seed in {seeds}:
        gen = torch.Generator("cuda").manual_seed(seed)
        h, W, b, labels, g = cs.ce_inputs(dtype, gen, n, d, v)
        lse = ce.ce_fwd_reference(h, W, b, labels)[1]
        got = ce.ce_bwd(h, W, b, labels, lse, g)
        want = ce.ce_bwd_reference(h, W, b, labels, lse, g)
        part = ce.ce_bwd_reference(h, W, b, labels, lse, g, True)
        err = cs.max_err(got, want, relative=True)
        soft = cs.softmax_part_err(got, want, part)
        print("READ " + json.dumps({{
            "fault": {fault!r}, "dtype": str(dtype)[6:], "seed": seed,
            "max_err": err, "tol": cs.TOL[dtype],
            "caught_by_tol": not err <= cs.TOL[dtype],
            "softmax_err": soft, "softmax_tol": cs.SOFTMAX_TOL[dtype],
            "caught_by_softmax_tol": not soft <= cs.SOFTMAX_TOL[dtype]}}),
            flush=True)
"""


def planted_copy(tmp: Path, fault: str) -> Path:
    """A copy of the package under tmp/<fault> with the fault's edit."""
    where = tmp / fault
    shutil.copytree(ROOT / "deepsc_gan_tpu_torch",
                    where / "deepsc_gan_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if FAULTS[fault] is not None:
        old, new = FAULTS[fault]
        src = where / "deepsc_gan_tpu_torch" / "csrc" / "ce_bwd.cu"
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{fault}: the line to edit is not in "
                               f"ce_bwd.cu once")
        src.write_text(text.replace(old, new))
    return where


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}")
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for fault in FAULTS:
            dtypes = ("torch.float32, torch.bfloat16" if fault == "none"
                      else "torch.bfloat16,")
            code = READ.format(root=str(ROOT), dtypes=f"({dtypes})",
                               seeds=tuple(args.seeds), fault=fault)
            # the copy's directory first on sys.path: its package, not ROOT's
            procs[fault] = subprocess.Popen(
                [sys.executable, "-c", code], cwd=planted_copy(Path(tmp),
                                                               fault),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for fault, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{fault} failed (exit {proc.returncode})"
                                   f":\n{out[-4000:]}\n{err[-4000:]}")
            for line in out.splitlines():
                if line.startswith("READ "):
                    print(line[5:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
