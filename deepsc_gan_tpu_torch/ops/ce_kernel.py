"""Online-softmax vocab cross-entropy: the CUDA kernels `csrc/ce_fwd.cu`
(K3, the port of the TPU kernel `_fwd_kernel`) and `csrc/ce_bwd.cu` (K4, the
port of `_dh_kernel` and `_dw_kernel`, deepsc_gan_tpu/ops/pallas/ce.py),
their wrappers and plain PyTorch versions, and the `torch.autograd.Function`
of the per-row CE.

`softmax_xent(h, W, b, labels)` computes, per row of h (N, D),
`logsumexp_v(h . W_v + b_v) - (h . W_y + b_y)` over the vocab table W
(V, D), the port's layout (the JAX package's W is (D, V)): a tied decoder
passes its embedding table and an untied one its `nn.Linear` weight, both
already (V, D). Products take operands in h's dtype when it is bf16 and in
f32 otherwise, with f32 sums and softmax arithmetic (`_op_dtype`,
deepsc_gan_tpu/ops/fused_ce.py:51-54). The backward returns dh in h's
dtype, dW in W's and db in b's, as the TPU package's VJP does. On CUDA
tensors each wrapper launches its kernel (and counts the launch) or raises;
on CPU tensors it runs the plain version, which is also what the kernels are
held against on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deepsc_gan_tpu_torch.ops import build

KERNEL_FWD = "ce_fwd"
KERNEL_BWD = "ce_bwd"
TILE_V = 64     # vocab rows per tile (csrc/ce_tile.cuh)
TILE_N = 64     # rows of h per tile
MAX_D = 256
# blocks per SM the vocab splits aim for (two blocks of ~80 KB fit an SM)
BLOCKS_PER_SM = 2

# Launches of the forward (K3) and backward (K4) kernels since the last
# reset (each wrapper adds one per call that launches its kernels and
# nowhere else); read by chip_smoke.py to show that a path went through
# them.
fwd_launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


def op_dtype(h: torch.Tensor) -> torch.dtype:
    """Matmul operand dtype: bf16 for bf16 activations, else f32."""
    return torch.bfloat16 if h.dtype == torch.bfloat16 else torch.float32


def _operands(h, W, b, labels):
    od = op_dtype(h)
    return (h.to(od).contiguous(), W.to(od).contiguous(),
            b.to(torch.float32).contiguous(),
            labels.to(torch.int32).contiguous())


def _logits(h, W, b):
    """(N, V) f32 logits of operands already in the op dtype: exact
    products, f32 sums."""
    return torch.matmul(h.float(), W.float().t()) + b


def ce_fwd_reference(h, W, b, labels):
    """Plain PyTorch version of K3 (the arithmetic of `fused_softmax_xent`,
    deepsc_gan_tpu/ops/fused_ce.py:43-144, with the logits materialized):
    -> (ce, lse), both (N,) f32."""
    h, W, b, labels = _operands(h, W, b, labels)
    logits = _logits(h, W, b)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels.long()[:, None])[:, 0]
    return lse - gold, lse


def ce_bwd_reference(h, W, b, labels, lse, g):
    """Plain PyTorch version of K4: P = exp(logits - lse) g - onehot g in
    f32; dh = Pc W, dW = Pc^T h with Pc = P rounded to the op dtype;
    db = sum_n P. -> (dh (N, D), dW (V, D), db (V,)), all f32."""
    h, W, b, labels = _operands(h, W, b, labels)
    g = g.to(torch.float32)
    p = torch.exp(_logits(h, W, b) - lse[:, None]) * g[:, None]
    rows = torch.arange(p.shape[0], device=p.device)
    p[rows, labels.long()] -= g
    pc = p.to(h.dtype).float()
    return pc @ W.float(), pc.t() @ h.float(), p.sum(dim=0)


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_POINTERS = {KERNEL_FWD: 7, KERNEL_BWD: 10}
_BOUND = {}


def _bind(kernel, dtype):
    """(launch function, shared-memory size function) of the built
    library of `kernel`, with their ctypes signatures declared."""
    if (kernel, dtype) not in _BOUND:
        lib = build.load(kernel)
        fn = getattr(lib, f"deepsc_{kernel}_{_SUFFIX[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * _POINTERS[kernel]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"deepsc_{kernel}_smem_bytes")
        smem.argtypes = [ctypes.c_int]
        smem.restype = ctypes.c_size_t
        _BOUND[(kernel, dtype)] = (fn, smem)
    return _BOUND[(kernel, dtype)]


def _on_cuda(h):
    """True for a CUDA tensor on the current device, False for a CPU
    tensor; raises for anything else."""
    if h.device.type == "cpu":
        return False
    if h.device.type != "cuda":
        raise ValueError(f"CE kernels run on CUDA, not {h.device}")
    if h.device.index != torch.cuda.current_device():
        raise ValueError(f"h is on {h.device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return True


def _check(h, W, b, labels, *rows):
    """What the kernels take: h (N, D) and W (V, D) of one dtype, f32 or
    bf16, D a multiple of 8 up to 256; b (V,) f32; int32 labels and f32
    per-row vectors (N,); all contiguous, 16-byte aligned, on h's device."""
    if h.dtype not in _SUFFIX or W.dtype != h.dtype:
        raise TypeError(f"CE kernels take h and W of one dtype, float32 or "
                        f"bfloat16, not {h.dtype} and {W.dtype}")
    if h.dim() != 2 or W.dim() != 2 or W.shape[1] != h.shape[1]:
        raise ValueError(f"bad shapes h {tuple(h.shape)} W {tuple(W.shape)}"
                         f" (want (N, D) and (V, D))")
    n, d = h.shape
    if d % 8 or d > MAX_D:
        raise ValueError(f"D {d}: the CE kernels take a multiple of 8 up to "
                         f"{MAX_D}")
    if b.dtype != torch.float32 or tuple(b.shape) != (W.shape[0],):
        raise ValueError(f"b must be float32 ({W.shape[0]},)")
    if labels.dtype != torch.int32 or tuple(labels.shape) != (n,):
        raise ValueError(f"labels must be int32 ({n},)")
    for t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"per-row inputs must be float32 ({n},)")
    for t in (h, W, b, labels) + rows:
        if t.device != h.device:
            raise ValueError(f"a CE input is on {t.device}, h on {h.device}")
        if not t.is_contiguous():
            raise ValueError("CE kernel inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("CE kernel inputs must be 16-byte aligned")


def vocab_splits(n: int, v: int, sm_count: int) -> int:
    """Vocab ranges the row tiles are cut into, so about BLOCKS_PER_SM
    blocks per SM run at once; every range owns at least one vocab tile."""
    tiles = math.ceil(v / TILE_V)
    want = max(1, math.ceil(BLOCKS_PER_SM * sm_count / math.ceil(n / TILE_N)))
    per = math.ceil(tiles / min(want, tiles))
    return math.ceil(tiles / per)


def _launch_setup(kernel, h):
    fn, smem_bytes = _bind(kernel, h.dtype)
    props = torch.cuda.get_device_properties(h.device)
    smem = smem_bytes(h.shape[1])
    if smem > props.shared_memory_per_block_optin:
        raise ValueError(f"{kernel} kernel needs {smem} bytes of shared "
                         f"memory per block; the device allows "
                         f"{props.shared_memory_per_block_optin}")
    return fn, props.multi_processor_count


def ce_fwd(h, W, b, labels):
    """K3's wrapper: -> (ce, lse), both (N,) f32."""
    if not _on_cuda(h):
        return ce_fwd_reference(h, W, b, labels)
    h, W, b, labels = _operands(h, W, b, labels)
    _check(h, W, b, labels)
    fn, sms = _launch_setup(KERNEL_FWD, h)
    (n, d), v = h.shape, W.shape[0]
    splits = vocab_splits(n, v, sms)
    f32 = {"dtype": torch.float32, "device": h.device}
    ce = torch.empty(n, **f32)
    lse = torch.empty(n, **f32)
    part = torch.empty((splits, n, 3), **f32)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(h.data_ptr(), W.data_ptr(), b.data_ptr(), labels.data_ptr(),
             ce.data_ptr(), lse.data_ptr(), part.data_ptr(), n, d, v, splits,
             stream)
    if err != 0:
        raise RuntimeError(f"CE forward kernel launch failed: CUDA error "
                           f"{err}")
    global fwd_launches
    fwd_launches += 1
    return ce, lse


def ce_bwd(h, W, b, labels, lse, g):
    """K4's wrapper: -> (dh (N, D), dW (V, D), db (V,)), all f32."""
    if not _on_cuda(h):
        return ce_bwd_reference(h, W, b, labels, lse, g)
    h, W, b, labels = _operands(h, W, b, labels)
    lse = lse.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    _check(h, W, b, labels, lse, g)
    fn, sms = _launch_setup(KERNEL_BWD, h)
    (n, d), v = h.shape, W.shape[0]
    splits = vocab_splits(n, v, sms)
    f32 = {"dtype": torch.float32, "device": h.device}
    dh = torch.empty((n, d), **f32)
    dW = torch.empty((v, d), **f32)
    db = torch.empty(v, **f32)
    dh_part = torch.empty((splits, n, d), **f32)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(h.data_ptr(), W.data_ptr(), b.data_ptr(), labels.data_ptr(),
             lse.data_ptr(), g.data_ptr(), dh.data_ptr(), dW.data_ptr(),
             db.data_ptr(), dh_part.data_ptr(), n, d, v, splits, stream)
    if err != 0:
        raise RuntimeError(f"CE backward kernel launch failed: CUDA error "
                           f"{err}")
    global bwd_launches
    bwd_launches += 1
    return dh, dW, db


class SoftmaxXent(torch.autograd.Function):
    """Per-row CE: forward K3, backward K4 (or both plain versions when
    `plain`), saving h, W, b, labels and lse as the TPU package's custom
    VJP does."""

    @staticmethod
    def forward(ctx, h, W, b, labels, plain):
        fwd = ce_fwd_reference if plain else ce_fwd
        ce, lse = fwd(h, W, b, labels)
        ctx.save_for_backward(h, W, b, labels, lse)
        ctx.plain = plain
        return ce

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h, W, b, labels, lse = ctx.saved_tensors
        bwd = ce_bwd_reference if ctx.plain else ce_bwd
        dh, dW, db = bwd(h, W, b, labels, lse, g)
        return dh.to(h.dtype), dW.to(W.dtype), db.to(b.dtype), None, None


def softmax_xent(h, W, b, labels, plain: bool = False):
    """(N,) f32 per-row CE of h (N, D) against the vocab table W (V, D) and
    bias b (V,); see the module docstring."""
    return SoftmaxXent.apply(h, W, b, labels, plain)
