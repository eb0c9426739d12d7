"""Fused beam-candidate scorer: the CUDA kernel `csrc/topk.cu` (K6, the port
of the TPU kernel `_topk_kernel`, deepsc_gan_tpu/ops/pallas/topk.py), its
wrapper and its plain PyTorch version.

`topk_logits(h, W, b, k)` returns, per row of h (N, D), the k largest raw
logits of `h . W_v + b_v` over the vocab table W (V, D) in descending order,
ties going to the lowest vocab index, their indices, and the row's
logsumexp: vals (N, k) f32, idx (N, k) int32, lse (N,) f32, so that
`vals - lse[:, None]` is the log-softmax at those positions. W is the port's
(V, D) layout (the JAX package's is (D, V)): a tied decoder passes its
embedding table, an untied one its `nn.Linear` weight. Products take
operands in h's dtype when it is bf16 and in f32 otherwise, with f32 sums
and bias (`op_dtype`, as the CE kernels). On CUDA tensors the wrapper
launches the kernel (and counts the launch) or raises; on CPU tensors it
runs the plain version, which is also what the kernel is held against on
the card. Each dtype has one kernel: bf16 multiplies on the tensor cores
(wgmma) and f32 on the CUDA cores in exact f32, which the f32 beam id
checks need. The vocab splits come from `ce_kernel.vocab_splits` fed by
the library's tiles and blocks per SM (`deepsc_topk_tiling_*`).

`take_top` is the selection both use, and beam search's second stage too:
k rounds of (max, lowest index reaching the max), each winner masked to
NEG. `torch.topk` is not used: its order on ties is not specified.
"""

from __future__ import annotations

import ctypes

import torch

from deepsc_gan_tpu_torch.ops import build
from deepsc_gan_tpu_torch.ops.ce_kernel import (
    MAX_D,
    _on_cuda,
    op_dtype,
    tiling,
    vocab_splits,
)

KERNEL = "topk"
NEG = -1e30
IBIG = 2 ** 30
MAX_K = 8       # the kernel keeps a sorted list of at most 8 per row
D_STEP = 8      # D a multiple of 8, up to ce_kernel.MAX_D

# Launches of K6 since the last reset (the wrapper adds one per launch and
# nowhere else); read by chip_smoke.py to show that a path went through it.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def take_top(x: torch.Tensor, cols: torch.Tensor, k: int):
    """k rounds over the last axis of x: the max, then the lowest of `cols`
    where x reaches it; the winner is masked to NEG before the next round.
    -> (vals (..., k) in x's dtype, idx (..., k) int32). x is not changed."""
    vals, idxs = [], []
    big = torch.full_like(cols, IBIG)
    for _ in range(k):
        mx = x.amax(dim=-1, keepdim=True)
        ix = torch.where(x == mx, cols, big).amin(dim=-1, keepdim=True)
        vals.append(mx)
        idxs.append(ix)
        x = torch.where(cols == ix, torch.full_like(x, NEG), x)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1).to(torch.int32)


def _operands(h, W, b):
    od = op_dtype(h.dtype)
    return (h.to(od).contiguous(), W.to(od).contiguous(),
            b.to(torch.float32).contiguous())


def topk_logits_reference(h, W, b, k: int):
    """Plain PyTorch version of K6 (`_xla_topk_logits`, topk.py:178-188):
    the (N, V) f32 logits materialized, lse = m + log(sum exp(logits - m)),
    then `take_top`. -> (vals (N, k) f32, idx (N, k) int32, lse (N,) f32)."""
    h, W, b = _operands(h, W, b)
    logits = torch.matmul(h.float(), W.float().t()) + b
    m = logits.amax(dim=-1, keepdim=True)
    s = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    cols = torch.arange(logits.shape[1], device=logits.device,
                        dtype=torch.int32).expand(logits.shape)
    vals, idx = take_top(logits, cols, k)
    return vals, idx, (m + torch.log(s))[:, 0]


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_BOUND = {}


def _bind(dtype):
    """(launch function, shared-memory size function) of the built
    library, with their ctypes signatures declared."""
    if dtype not in _BOUND:
        lib = build.load(KERNEL)
        fn = getattr(lib, f"deepsc_topk_{_SUFFIX[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"deepsc_topk_smem_bytes_{_SUFFIX[dtype]}")
        smem.argtypes = [ctypes.c_int]
        smem.restype = ctypes.c_size_t
        _BOUND[dtype] = (fn, smem)
    return _BOUND[dtype]


def _check(h, W, b, k):
    """What the kernel takes: h (N, D) and W (V, D) of one dtype, f32 or
    bf16, D a multiple of 8 up to 256; b (V,) f32; 1 <= k <= min(8, V); all
    contiguous, 16-byte aligned, on h's device."""
    if h.dtype not in _SUFFIX or W.dtype != h.dtype:
        raise TypeError(f"K6 takes h and W of one dtype, float32 or "
                        f"bfloat16, not {h.dtype} and {W.dtype}")
    if h.dim() != 2 or W.dim() != 2 or W.shape[1] != h.shape[1]:
        raise ValueError(f"bad shapes h {tuple(h.shape)} W {tuple(W.shape)}"
                         f" (want (N, D) and (V, D))")
    d, v = h.shape[1], W.shape[0]
    if d % D_STEP or d > MAX_D:
        raise ValueError(f"D {d}: K6 takes a multiple of {D_STEP} up to "
                         f"{MAX_D}")
    if not 1 <= k <= min(MAX_K, v):
        raise ValueError(f"k {k}: K6 takes 1 <= k <= {MAX_K} and k <= V")
    if b.dtype != torch.float32 or tuple(b.shape) != (v,):
        raise ValueError(f"b must be float32 ({v},)")
    for t in (h, W, b):
        if t.device != h.device:
            raise ValueError(f"a K6 input is on {t.device}, h on {h.device}")
        if not t.is_contiguous():
            raise ValueError("K6 inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("K6 inputs must be 16-byte aligned")


def topk_logits(h, W, b, k: int = 4):
    """K6's wrapper: -> (vals (N, k) f32, idx (N, k) int32, lse (N,) f32);
    see the module docstring. A W already in the op dtype is used as it is
    (the beam decoders cast the table once per call, not once per step)."""
    if not _on_cuda(h):
        return topk_logits_reference(h, W, b, k)
    h, W, b = _operands(h, W, b)
    _check(h, W, b, k)
    fn, smem_bytes = _bind(h.dtype)
    props = torch.cuda.get_device_properties(h.device)
    if smem_bytes(h.shape[1]) > props.shared_memory_per_block_optin:
        raise ValueError(f"K6 needs {smem_bytes(h.shape[1])} bytes of shared "
                         f"memory per block; the device allows "
                         f"{props.shared_memory_per_block_optin}")
    (n, d), v = h.shape, W.shape[0]
    splits = vocab_splits(n, v, props.multi_processor_count,
                          *tiling(KERNEL, h.dtype, d, h.device))
    dev = h.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    part_v = torch.empty((splits, n, MAX_K), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, n, MAX_K), dtype=torch.int32, device=dev)
    part_ms = torch.empty((splits, n, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(h.data_ptr(), W.data_ptr(), b.data_ptr(), vals.data_ptr(),
             idx.data_ptr(), lse.data_ptr(), part_v.data_ptr(),
             part_i.data_ptr(), part_ms.data_ptr(), n, d, v, k, splits,
             stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {err}")
    global launches
    launches += 1
    return vals, idx, lse

