"""Star-Transformer satellite update: the CUDA kernel
`csrc/star_satellite.cu` (K5, the port of the TPU kernel `_satellite_kernel`,
deepsc_gan_tpu/ops/pallas/star.py:107), its wrapper and plain PyTorch
versions, the analytic backward, and the `torch.autograd.Function` that joins
them as the TPU package's custom VJP does.

`star_satellite(q, kh, vh, ke, ve, ks, vs, heads)` takes the ring as the
caller projects it: q, kh and vh (B, L, D) from the satellites h, ke and ve
(B, L, D) from the embeddings e, ks and vs (B, D) from the relay s. It
computes the TPU kernel's function (`star_satellite_attention`, star.py:185)
on the five stacked contexts that the JAX model builds from them
(deepsc_gan_tpu/models/star.py:119-125; `contexts` here): {h_{i+1}, h_i,
h_{i-1}, e_i, s}, the neighbours rolled circularly over the padded length.
Per row and head: the scores q . k_j / sqrt(Dh) over the five in f32, a
softmax over the five and sum_j w_j v_j, returned as (B, L, D) in q's dtype.
The kernel reads the ring unstacked (a neighbour by index); the plain
version `ring_reference` stacks it and runs `satellite_reference`, the
TPU package's `_xla_satellite` on the stacked, flattened contexts. A width
or head layout the kernel does not take goes to `csrc/star_wide.cu` (a
group of lanes per row, or at widths past one warp's a warp per row and
head; `wide_plan`). On
CUDA tensors the wrapper launches the kernel (and counts the launch) or
raises; on CPU tensors it runs the plain version, which is also what the
kernel is held against on the card.

The TPU backward is an analytic XLA VJP, not a Pallas kernel, so the
backward here is plain PyTorch on every device: `satellite_backward` on the
stacked contexts, recomputed, each of the five context gradients rounded to
the input dtype as `_star_bwd` returns them, then folded back onto the ring
(`_fold`: the rolls undone, the relay's summed over the length).
`satellite_attention` is the Function through K5, `plain_satellite` the
same Function through the plain version on any device (chip_smoke.py's
yardstick for whole decodes and steps).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from deepsc_gan_tpu_torch.ops import build
from deepsc_gan_tpu_torch.ops.ce_kernel import _on_cuda

KERNEL = "star_satellite"
KERNEL_WIDE = "star_wide"
CONTEXTS = 5
# what the tuned kernel takes (csrc/star_satellite.cu): a warp per row, each
# lane holding D / 32 consecutive elements, so D is 32 x (2, 4 or 8); a
# head's Dh elements span a power of two of lanes; any B and L. Any other D
# and head count that divides it goes to the wide kernels
# (csrc/star_wide.cu, `wide_plan`)
WIDTHS = (64, 128, 256)
# the wide kernels' chunks a lane on the group path (1, 2 or MAX_CHUNKS)
MAX_CHUNKS = 4


class WidePlan(NamedTuple):
    """How csrc/star_wide.cu takes a width (its `deepsc_star_wide_plan`):
    `path` "group" (a group of `lanes` lanes per row, each `chunks`
    consecutive chunks of `chunk_bytes`) or "head" (a warp per row and
    head, the head's chunks of `chunk_bytes`, 32 a pass)."""
    path: str
    chunk_bytes: int
    chunks: int
    lanes: int


def wide_plan(d: int, heads: int, size: int) -> WidePlan:
    """The wide kernels' plan for width d in `heads` heads of `size`-byte
    elements: the group path with the largest chunk of 16, 8, 4 (2) bytes
    dividing the row's bytes and the fewest chunks a lane (1, 2 or
    MAX_CHUNKS) that fit the row in 32 lanes, a lane's elements no more
    than a head's (so they span at most two heads); else the head path,
    its chunk the largest dividing a head's bytes."""
    dh = d // heads
    cb = 16
    while cb >= size:
        kv = cb // size
        nc = d // kv
        c = 1
        while (d * size) % cb == 0 and c <= MAX_CHUNKS and c * kv <= dh:
            if nc <= 32 * c:
                return WidePlan("group", cb, c, -(-nc // c))
            c *= 2
        cb //= 2
    cb = 16
    while (dh * size) % cb:
        cb //= 2
    return WidePlan("head", cb, 1, 32)


def library_plan(d: int, heads: int, size: int) -> WidePlan:
    """`wide_plan` as the built library computes it."""
    fn = build.load(KERNEL_WIDE).deepsc_star_wide_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(d, heads, size, out)
    if err != 0:
        raise ValueError(f"{KERNEL_WIDE} does not take D {d} in {heads} "
                         f"heads: CUDA error {err}")
    return WidePlan(("group", "head")[out[0]], *out[1:])


def takes_width(d: int, heads: int) -> bool:
    """Whether the tuned K5 takes width D = d in `heads` heads: D in WIDTHS
    and a head width that is a power of two of at least D / 32."""
    dh = d // heads if heads > 0 and d % heads == 0 else 0
    return d in WIDTHS and dh >= d // 32 and dh & (dh - 1) == 0


def takes_heads(d: int, heads: int) -> bool:
    """Whether some K5 kernel takes width D = d in `heads` heads: any
    number of heads that divides D, as the star model's heads must."""
    return heads > 0 and d > 0 and d % heads == 0


# Launches of K5 since the last reset (the wrapper adds one per launch and
# nowhere else; `wide_launches` counts the calls among them that went to
# the wide kernels); read by chip_smoke.py to show that a path went through
# it.
launches = 0
wide_launches = 0


def reset_launches() -> None:
    global launches, wide_launches
    launches = 0
    wide_launches = 0


def contexts(x, xe, xs):
    """The five stacked contexts of the ring (the JAX model's `k_ctx` /
    `v_ctx`): x and xe (B, L, D), xs (B, D) -> (5, B, L, D) =
    [roll(x, -1, 1), x, roll(x, 1, 1), xe, xs broadcast over L]."""
    return torch.stack([x.roll(-1, 1), x, x.roll(1, 1), xe,
                        xs[:, None].expand_as(x)])


def _fold(d_ctx):
    """The gradient of `contexts`: (5, B, L, D) -> (dx, dxe, dxs)."""
    return (d_ctx[0].roll(1, 1) + d_ctx[1] + d_ctx[2].roll(-1, 1), d_ctx[3],
            d_ctx[4].sum(dim=1))


def _split(x, heads):
    """(..., D) -> (..., H, Dh) in f32."""
    return x.reshape(*x.shape[:-1], heads, x.shape[-1] // heads).float()


def _weights(qh, kh):
    """Softmax over the contexts (axis 0) of q . k_j / sqrt(Dh):
    (5, ..., H) f32."""
    scores = (qh[None] * kh).sum(dim=-1) / math.sqrt(qh.shape[-1])
    return torch.softmax(scores, dim=0)


def satellite_reference(q2, k2, v2, heads: int):
    """Plain PyTorch version of K5 (`_xla_satellite`, star.py:252): q2
    (N, D), k2 and v2 (5, N, D) -> (N, D) in q2's dtype."""
    w = _weights(_split(q2, heads), _split(k2, heads))
    out = (w[..., None] * _split(v2, heads)).sum(dim=0)
    return out.reshape(q2.shape).to(q2.dtype)


def ring_reference(q, kh, vh, ke, ve, ks, vs, heads: int):
    """Plain PyTorch version of K5 on the ring (see the module docstring):
    `contexts`, then `satellite_reference` -> (B, L, D) in q's dtype."""
    n = q.shape[0] * q.shape[1]
    return satellite_reference(
        q.reshape(n, -1), contexts(kh, ke, ks).reshape(CONTEXTS, n, -1),
        contexts(vh, ve, vs).reshape(CONTEXTS, n, -1), heads).reshape(q.shape)


def satellite_backward(q, k_ctx, v_ctx, g, heads: int):
    """The analytic VJP (`_star_bwd`, star.py:218-246), in f32 with the
    weights recomputed: dv_j = w_j g; a_j = g . v_j per head;
    ds_j = w_j (a_j - sum_i w_i a_i); dq = sum_j ds_j k_j / sqrt(Dh);
    dk_j = ds_j q / sqrt(Dh). -> (dq, dk, dv) in the inputs' dtypes."""
    qh, kh, vh, gh = (_split(t, heads) for t in (q, k_ctx, v_ctx, g))
    scale = 1.0 / math.sqrt(qh.shape[-1])
    w = _weights(qh, kh)
    dv = w[..., None] * gh[None]
    a = (gh[None] * vh).sum(dim=-1)
    ds = w * (a - (w * a).sum(dim=0, keepdim=True))
    dq = (ds[..., None] * kh).sum(dim=0) * scale
    dk = ds[..., None] * qh[None] * scale
    return (dq.reshape(q.shape).to(q.dtype),
            dk.reshape(k_ctx.shape).to(k_ctx.dtype),
            dv.reshape(v_ctx.shape).to(v_ctx.dtype))


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_BOUND = {}


def _bind(kernel, dtype):
    """The launch function of the built library `kernel` (the tuned or the
    wide one) for `dtype`, with its ctypes signature declared (both take
    the same arguments)."""
    if (kernel, dtype) not in _BOUND:
        entry = "star_satellite" if kernel == KERNEL else "star_wide"
        fn = getattr(build.load(kernel), f"deepsc_{entry}_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[(kernel, dtype)] = fn
    return _BOUND[(kernel, dtype)]


RING = ("q", "kh", "vh", "ke", "ve", "ks", "vs")


def _check(ring, heads):
    """What the kernels take: q, kh, vh, ke, ve (B, L, D) and ks, vs (B, D)
    of one dtype, f32 or bf16; heads dividing D (the tuned kernel: D in
    WIDTHS and a head width Dh that is a power of two of at least D / 32;
    the wide kernels any other); all contiguous, 16-byte aligned, on q's
    device. Any B and L."""
    q = ring[0]
    if q.dtype not in _SUFFIX or any(t.dtype != q.dtype for t in ring):
        raise TypeError(f"K5 takes q, kh, vh, ke, ve, ks, vs of one dtype, "
                        f"float32 or bfloat16, not "
                        f"{[str(t.dtype) for t in ring]}")
    shapes = [tuple(t.shape) for t in ring]
    if q.dim() != 3 or shapes[1:5] != [shapes[0]] * 4 \
            or shapes[5:] != [(q.shape[0], q.shape[2])] * 2:
        raise ValueError(f"bad shapes {dict(zip(RING, shapes))} (want "
                         f"(B, L, D) for q, kh, vh, ke, ve and (B, D) for "
                         f"ks, vs)")
    d = q.shape[-1]
    if not takes_heads(d, heads):
        raise ValueError(f"D {d} with {heads} heads: K5 takes a number of "
                         f"heads that divides D")
    for name, t in zip(RING, ring):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def star_satellite(q, kh, vh, ke, ve, ks, vs, heads: int):
    """K5's wrapper: the satellite update of the ring, (B, L, D) in q's
    dtype; see the module docstring."""
    ring = (q, kh, vh, ke, ve, ks, vs)
    if not _on_cuda(q):
        return ring_reference(*ring, heads)
    _check(ring, heads)
    b, length, d = q.shape
    wide = not takes_width(d, heads)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bind(KERNEL_WIDE if wide else KERNEL, q.dtype)(
        *(t.data_ptr() for t in ring), out.data_ptr(), b, length, d, heads,
        stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed: CUDA error {err}")
    global launches, wide_launches
    launches += 1
    wide_launches += wide
    return out


class SatelliteAttention(torch.autograd.Function):
    """Forward K5 (or the plain version when `plain`), backward
    `satellite_backward` on the recomputed contexts, folded onto the ring;
    saves the ring (no stacked copy)."""

    @staticmethod
    def forward(ctx, q, kh, vh, ke, ve, ks, vs, heads, plain):
        ctx.save_for_backward(q, kh, vh, ke, ve, ks, vs)
        ctx.heads = heads
        fn = ring_reference if plain else star_satellite
        return fn(q, kh, vh, ke, ve, ks, vs, heads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, kh, vh, ke, ve, ks, vs = ctx.saved_tensors
        dq, dk, dv = satellite_backward(q, contexts(kh, ke, ks),
                                        contexts(vh, ve, vs), g, ctx.heads)
        (dkh, dke, dks), (dvh, dve, dvs) = _fold(dk), _fold(dv)
        return dq, dkh, dvh, dke, dve, dks, dvs, None, None


def satellite_attention(q, kh, vh, ke, ve, ks, vs, heads: int):
    """The satellite update through K5, with `satellite_backward` as its
    backward."""
    return SatelliteAttention.apply(q, kh, vh, ke, ve, ks, vs, heads, False)


def plain_satellite(q, kh, vh, ke, ve, ks, vs, heads: int):
    """`satellite_attention` through the plain version on any device."""
    return SatelliteAttention.apply(q, kh, vh, ke, ve, ks, vs, heads, True)
