"""Fused multi-head attention: the CUDA kernels `csrc/attention_fwd.cu`
(K1, the port of the TPU kernel `_fwd_kernel`) and `csrc/attention_bwd.cu`
(K2, the port of `_bwd_kernel`, deepsc_gan_tpu/ops/pallas/attention.py),
their wrappers and plain PyTorch versions, and the `torch.autograd.Function`
that joins them as the TPU package's custom VJP does.

`fused_attention(q, k, v, bias, heads, scale)` has the JAX signature of
the TPU kernel's entry point: q (N, Lq, H*Dh), k and v (N, Lk, H*Dh), bias
(N, Lq, Lk) additive f32 shared by the heads; it returns the per-head
contexts packed as (N, Lq, H*Dh) in q's dtype, and its backward returns dq,
dk, dv and (when the bias needs one) dbias. On CUDA tensors each wrapper
launches its kernel (and counts the launch) or raises; on CPU tensors it
runs the plain version, which is also what the kernel is held against on
the card. `plain_attention` is the same Function through the plain
versions on any device (chip_smoke.py's yardstick for whole steps).
"""

from __future__ import annotations

import ctypes

import torch

from deepsc_gan_tpu_torch.ops import build

KERNEL = "attention_fwd"
KERNEL_BWD = "attention_bwd"
# what the kernel takes (csrc/attention_fwd.cu): a warp per head, a lane
# per query, the logits and context of a pair in registers
HEAD_DIMS = (8, 16, 32)
MAX_LEN = 32
MAX_HEADS = 16

# Launches of the forward (K1) and backward (K2) kernels since the last
# reset (each wrapper adds one per launch and nowhere else); read by
# chip_smoke.py to show that a path went through the kernels.
launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0


def _heads(x, heads):
    """(N, L, H*Dh) -> (N, H, L, Dh) in f32."""
    n, length, hd = x.shape
    return x.reshape(n, length, heads, hd // heads).transpose(1, 2).float()


def _merge(x, dtype):
    """(N, H, L, Dh) -> (N, L, H*Dh) in `dtype`."""
    n, h, length, dh = x.shape
    return x.transpose(1, 2).reshape(n, length, h * dh).to(dtype)


def _probs(qh, kh, bias, scale):
    """The forward's f32 probabilities (N, H, Lq, Lk): logits
    `q k^T * (1/scale)` then `+ bias`, softmax as e / sum(e)."""
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / scale)
    s = s + bias.float()[:, None]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def attention_fwd_reference(q, k, v, bias, heads: int, scale: float):
    """Plain PyTorch version of K1: per head,
    softmax(q k^T * (1/scale) + bias) v with f32 logits and softmax, the
    probabilities rounded to v's dtype, the context summed in f32."""
    p = _probs(_heads(q, heads), _heads(k, heads), bias, scale)
    ctx = torch.matmul(p.to(v.dtype).float(), _heads(v, heads))
    return _merge(ctx, q.dtype)


def attention_bwd_reference(q, k, v, bias, g, heads: int, scale: float,
                            need_dbias: bool = True):
    """Plain PyTorch version of K2 (the TPU kernel's VJP): p recomputed in
    f32; dv = pc^T g with pc = p rounded to the input dtype; dp = g v^T;
    ds = p (dp - rowsum(dp p)); dq = dss k and dk = dss^T q with
    dss = (ds * (1/scale)) rounded to the input dtype; dbias = sum_h ds in
    f32 (None unless `need_dbias`). -> (dq, dk, dv, dbias)."""
    qh, kh, vh, gh = (_heads(t, heads) for t in (q, k, v, g))
    p = _probs(qh, kh, bias, scale)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dss = (ds * (1.0 / scale)).to(q.dtype).float()
    dq = torch.matmul(dss, kh)
    dk = torch.matmul(dss.transpose(-1, -2), qh)
    dbias = ds.sum(dim=1) if need_dbias else None
    return (_merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype),
            dbias)


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_POINTERS = {KERNEL: 5, KERNEL_BWD: 9}
_BOUND = {}


def _bind(kernel, dtype):
    """(launch function, shared-memory size function) of the built
    library of `kernel`, with their ctypes signatures declared."""
    if (kernel, dtype) not in _BOUND:
        lib = build.load(kernel)
        fn = getattr(lib, f"deepsc_{kernel}_{_SUFFIX[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * _POINTERS[kernel]
                       + [ctypes.c_int] * 5
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"deepsc_{kernel}_smem_bytes")
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_size_t
        _BOUND[(kernel, dtype)] = (fn, smem)
    return _BOUND[(kernel, dtype)]


def _check(q, k, v, bias, heads):
    if q.dtype not in _SUFFIX:
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


def _on_cuda(q):
    """True for a CUDA tensor on the current device, False for a CPU
    tensor; raises for anything else."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel runs on CUDA, not {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return True


def _smem(kernel, q, k, heads):
    n, lq, hd = q.shape
    fn, smem_bytes = _bind(kernel, q.dtype)
    smem = smem_bytes(lq, k.shape[1], heads, hd // heads)
    limit = torch.cuda.get_device_properties(q.device) \
        .shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{kernel} kernel needs {smem} bytes of shared "
                         f"memory per block; the device allows {limit}")
    return fn


def attention_fwd(q, k, v, bias, heads: int, scale: float):
    """K1's wrapper: softmax(q k^T / scale + bias) v per head."""
    if not _on_cuda(q):
        return attention_fwd_reference(q, k, v, bias, heads, scale)
    _check(q, k, v, bias, heads)
    fn = _smem(KERNEL, q, k, heads)
    n, lq, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
             out.data_ptr(), n, lq, k.shape[1], heads, hd // heads,
             float(scale), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out


def attention_bwd(q, k, v, bias, g, heads: int, scale: float,
                  need_dbias: bool = True):
    """K2's wrapper: -> (dq, dk, dv, dbias or None) for the cotangent g of
    the forward's output."""
    if not _on_cuda(q):
        return attention_bwd_reference(q, k, v, bias, g, heads, scale,
                                       need_dbias)
    _check(q, k, v, bias, heads)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("g must be contiguous and 16-byte aligned")
    fn = _smem(KERNEL_BWD, q, k, heads)
    n, lq, hd = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dbias = torch.empty_like(bias) if need_dbias else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
             g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             None if dbias is None else dbias.data_ptr(), n, lq, k.shape[1],
             heads, hd // heads, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: CUDA "
                           f"error {err}")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv, dbias


class FusedAttention(torch.autograd.Function):
    """Forward K1, backward K2 (or both plain versions when `plain`),
    saving q, k, v and bias as the TPU package's custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, bias, heads, scale, plain):
        fwd = attention_fwd_reference if plain else attention_fwd
        ctx.save_for_backward(q, k, v, bias)
        ctx.heads, ctx.scale, ctx.plain = heads, scale, plain
        return fwd(q, k, v, bias, heads, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        bwd = attention_bwd_reference if ctx.plain else attention_bwd
        dq, dk, dv, dbias = bwd(q, k, v, bias, g.to(q.dtype).contiguous(),
                                ctx.heads, ctx.scale, ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None, None


def fused_attention(q, k, v, bias, heads: int, scale: float):
    """softmax(q k^T / scale + bias) v per head through K1, with K2 as its
    backward; see the module docstring."""
    return FusedAttention.apply(q, k, v, bias, heads, scale, False)


def plain_attention(q, k, v, bias, heads: int, scale: float):
    """`fused_attention` through the plain versions on any device."""
    return FusedAttention.apply(q, k, v, bias, heads, scale, True)
