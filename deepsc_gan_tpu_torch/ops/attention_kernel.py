"""Fused multi-head attention forward: the CUDA kernel
`csrc/attention_fwd.cu` (the port of the TPU kernel `_fwd_kernel`,
deepsc_gan_tpu/ops/pallas/attention.py), its wrapper, and its plain
PyTorch version.

`fused_attention(q, k, v, bias, heads, scale)` has the JAX signature of
the TPU kernel's entry point: q (N, Lq, H*Dh), k and v (N, Lk, H*Dh), bias
(N, Lq, Lk) additive f32 shared by the heads; it returns the per-head
contexts packed as (N, Lq, H*Dh) in q's dtype. On a CUDA tensor it launches
the kernel (and counts the launch) or raises; on a CPU tensor it runs the
plain version, which is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from deepsc_gan_tpu_torch.ops import build

KERNEL = "attention_fwd"
# what the kernel takes (csrc/attention_fwd.cu): a warp per head, a lane
# per query, the logits and context of a pair in registers
HEAD_DIMS = (8, 16, 32)
MAX_LEN = 32
MAX_HEADS = 16

# Launches of the CUDA kernel since the last reset (the wrapper adds one
# per launch and nowhere else); read by chip_smoke.py to show that the
# serving path went through the kernel.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def attention_fwd_reference(q, k, v, bias, heads: int, scale: float):
    """Plain PyTorch version of the kernel: per head,
    softmax(q k^T * (1/scale) + bias) v with f32 logits and softmax, the
    probabilities rounded to v's dtype, the context summed in f32."""
    n, lq, hd = q.shape
    lk = k.shape[1]
    dh = hd // heads
    qh = q.reshape(n, lq, heads, dh).transpose(1, 2).float()
    kh = k.reshape(n, lk, heads, dh).transpose(1, 2).float()
    vh = v.reshape(n, lk, heads, dh).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / scale)
    s = s + bias.float()[:, None]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(p.to(v.dtype).float(), vh.float())
    return ctx.transpose(1, 2).reshape(n, lq, hd).to(q.dtype)


_SYMBOLS = {torch.float32: "deepsc_attention_fwd_f32",
            torch.bfloat16: "deepsc_attention_fwd_bf16"}
_BOUND = {}


def _bind(dtype):
    """(launch function, shared-memory size function) of the built
    library, with their ctypes signatures declared."""
    if dtype not in _BOUND:
        lib = build.load(KERNEL)
        fn = getattr(lib, _SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.deepsc_attention_fwd_smem_bytes
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_size_t
        _BOUND[dtype] = (fn, smem)
    return _BOUND[dtype]


def _check(q, k, v, bias, heads):
    if q.dtype not in _SYMBOLS:
        raise TypeError(f"attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, not {bias.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    n, lq, hd = q.shape
    lk = k.shape[1]
    if k.shape[0] != n or k.shape[2] != hd or hd % heads:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} with {heads} heads")
    if tuple(bias.shape) != (n, lq, lk):
        raise ValueError(f"bias {tuple(bias.shape)} is not {(n, lq, lk)}")
    if hd // heads not in HEAD_DIMS or heads > MAX_HEADS:
        raise ValueError(f"{heads} heads of width {hd // heads}: the kernel "
                         f"takes widths {HEAD_DIMS}, at most {MAX_HEADS} "
                         f"heads")
    if lq > MAX_LEN or lk > MAX_LEN:
        raise ValueError(f"Lq {lq}, Lk {lk}: the kernel takes at most "
                         f"{MAX_LEN}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def fused_attention(q, k, v, bias, heads: int, scale: float):
    """softmax(q k^T / scale + bias) v per head; see the module docstring."""
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v, bias, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel runs on CUDA, not {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    _check(q, k, v, bias, heads)
    n, lq, hd = q.shape
    lk = k.shape[1]
    fn, smem_bytes = _bind(q.dtype)
    smem = smem_bytes(lq, lk, heads, hd // heads)
    limit = torch.cuda.get_device_properties(q.device) \
        .shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"attention kernel needs {smem} bytes of shared "
                         f"memory per block; the device allows {limit}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
             out.data_ptr(), n, lq, lk, heads, hd // heads, float(scale),
             stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out
