"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, runs on CUDA unless told otherwise, builds its kernels with plain
nvcc for sm_90a, and chip_smoke.py refuses to run without a GPU or without
the port beside it."""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import deepsc_gan_tpu_torch
from deepsc_gan_tpu_torch.ops import attention_kernel, build
from deepsc_gan_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        deepsc_gan_tpu_torch.__path__, "deepsc_gan_tpu_torch."))


def test_port_and_chip_smoke_import_no_jax():
    mods = _port_modules() + ["chip_smoke"]
    assert "deepsc_gan_tpu_torch.ops.attention_kernel" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'optax', 'deepsc_gan_tpu'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_nvcc_command_is_plain_sm90a():
    src = build.CSRC / "attention_fwd.cu"
    cmd = build.nvcc_command(src, Path("lib.so"), "nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and str(src) in cmd
    assert not [a for a in cmd if a.startswith("-I")]
    for cu in build.CSRC.glob("*.cu"):
        text = cu.read_text()
        assert "torch/" not in text and "ATen" not in text, cu


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


def test_kernel_wrapper_never_falls_back_off_the_cpu():
    q = torch.zeros((1, 2, 4), device="meta")
    bias = torch.zeros((1, 2, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention_kernel.fused_attention(q, q, q, bias, 1, 2.0)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_port(tmp_path, alone):
    """Without CUDA (here), and in a directory holding chip_smoke.py and
    nothing else of the repo, the script exits non-zero with no result."""
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
