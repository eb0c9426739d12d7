"""Build the port's CUDA sources into shared libraries with a plain C
interface, bound with `ctypes`.

Each source `csrc/<name>.cu` is compiled by `nvcc` alone (no PyTorch
header, no `torch.utils.cpp_extension`, no ninja) for `sm_90a` into
`_build/<name>-<hash>/lib<name>.so`, where the hash covers the source, the
shared headers `csrc/*.cuh` and the command, so an edited source is rebuilt
and an unchanged one is loaded from the earlier build. `_build/` is listed in `.gitignore`.
Nothing is compiled when a module is imported: the first wrapper call
builds, and a missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
# what nvcc printed for each source it built in this process (ptxas's
# registers, shared memory and spills per kernel, from -Xptxas -v)
LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the CUDA "
                           "kernels")
    return nvcc


def nvcc_command(source: Path, output: Path, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def _target(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(names: Sequence[str], force: bool = False) -> Dict[str, float]:
    """Compile `csrc/<name>.cu` for every name, all `nvcc` processes
    started together. Skips a library already built from the same source
    unless `force`. Returns the seconds each build took (0.0 if skipped);
    raises with the compiler's output if one fails."""
    started = {}
    for name in names:
        out = _target(name)
        if out.exists() and not force:
            started[name] = None
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(CSRC / f"{name}.cu", tmp, find_nvcc())
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {}
    for name, job in started.items():
        if job is None:
            seconds[name] = 0.0
            continue
        proc, tmp, out, t0 = job
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        LOGS[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees old or new
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library `lib<name>.so`, building it on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(_target(name)))
    return lib
