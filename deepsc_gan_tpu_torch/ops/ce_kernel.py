"""Online-softmax vocab cross-entropy: the CUDA kernels of K3 (the port of
the TPU kernel `_fwd_kernel`) and K4 (the port of `_dh_kernel` and
`_dw_kernel`, deepsc_gan_tpu/ops/pallas/ce.py),
their wrappers and plain PyTorch versions, and the `torch.autograd.Function`
of the per-row CE.

`softmax_xent(h, W, b, labels)` computes, per row of h (N, D),
`logsumexp_v(h . W_v + b_v) - (h . W_y + b_y)` over the vocab table W
(V, D), the port's layout (the JAX package's W is (D, V)): a tied decoder
passes its embedding table and an untied one its `nn.Linear` weight, both
already (V, D). Products take operands in h's dtype when it is bf16 and in
f32 otherwise, with f32 sums and softmax arithmetic (`_op_dtype`,
deepsc_gan_tpu/ops/fused_ce.py:51-54). The backward returns dh in h's
dtype, dW in W's and db in b's, as the TPU package's VJP does; when
neither W nor b needs a gradient (the attacks' gradient with respect to the
decoder's hidden states, the table passed detached), K4 runs in its dh-only
mode: the dh kernel alone, no dW/db kernel. On CUDA
tensors each wrapper launches its kernel (and counts the launch) or raises;
on CPU tensors it runs the plain version, which is also what the kernels are
held against on the card. bf16 multiplies on the tensor cores (wgmma):
the tuned kernels `csrc/ce_fwd.cu` and `csrc/ce_bwd.cu` at D a multiple of
16 up to 256, and off those widths K3 in `csrc/ce_wide_fwd.cu` (the tuned
K3's tile step with D streamed through a TMA ring in 64-column k-chunks of
h's and W's tiles) and K4 up to 5,120 columns in `csrc/ce_wide_bwd.cu` (the
output's D cut into 64-column slabs over the two warpgroups of a block
and, past 640 columns, over a cluster of blocks that share each tile's
logits through distributed shared memory). f32 multiplies on the CUDA
cores in exact f32, which the f32 step-parity checks need, at every width
on one 128 x 128 tile (`csrc/ce_tiled.cuh`): K3 in `csrc/ce_fwd_tiled.cu`
(the logits tile by tile under an online softmax), K4 in
`csrc/ce_bwd_tiled.cu` (P formed once into an (N, V) workspace, then dh =
Pc W and dW = Pc^T h as two tiled products that read it), which also takes
bf16 K4 past 5,120 columns.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from deepsc_gan_tpu_torch.ops import build

KERNEL_FWD = "ce_fwd"
KERNEL_BWD = "ce_bwd"
KERNEL_WIDE_BWD = "ce_wide_bwd"
KERNEL_WIDE_FWD = "ce_wide_fwd"
KERNEL_BWD_TILED = "ce_bwd_tiled"
KERNEL_FWD_TILED = "ce_fwd_tiled"
# the widths off which a call counts as wide: D a multiple of D_STEP (one
# wgmma k-step in bf16, 8 in f32) up to MAX_D is a tuned width; any other
# D >= 1 goes in bf16 to the wide kernels (csrc/ce_wide_fwd.cu and
# csrc/ce_wide_bwd.cu on the tensor cores); every f32 width runs the tiled
# kernels (csrc/ce_fwd_tiled.cu, csrc/ce_bwd_tiled.cu)
MAX_D = 256
D_STEP = {torch.float32: 8, torch.bfloat16: 16}
# the bf16 wide K3 on the tensor cores (csrc/ce_wide_fwd.cu): a ring of
# FWD_STAGES stages, each a k-chunk of SLAB columns of h's 64-row tile and of
# W's FWD_TILE-row tile
FWD_STAGES = 3
FWD_TILE = 128
# the bf16 wide K4 on the tensor cores (csrc/ce_wide_bwd.cu): rows of the
# TMA's tensor maps a multiple of PAD_STEP columns (16 bytes); D cut into
# slabs of SLAB columns, at most BLOCK_SLABS a block (two warpgroups of
# five), at most MAX_CLUSTER blocks a cluster (D up to 5,120); a resident
# tile of SLAB rows and a ring of at most MAX_STAGES streamed tiles of
# TILE rows (each with its rows' three f32 values), as many as fit
# SMEM_BUDGET bytes beside the resident tile and two SLAB x TILE f32 sums
PAD_STEP = 8
SLAB = 64
TILE = 32
BLOCK_SLABS = 10
MAX_CLUSTER = 8
MAX_STAGES = 4
SMEM_BUDGET = 232448 - 256
# the tiled K3 and K4 (csrc/ce_fwd_tiled.cu, csrc/ce_bwd_tiled.cu): tiles
# of TILED_TILE rows and columns; K4's P workspace has N and V rounded up to
# TILED_TILE, and the vocab splits of both each own whole vocab tiles
TILED_TILE = 128

# Launches of the forward (K3) and backward (K4) kernels since the last
# reset (each wrapper adds one per call that launches its kernels and
# nowhere else; `bwd_dh_only_launches` counts the K4 calls among them that
# ran in the dh-only mode, `wide_fwd_launches` and `wide_bwd_launches` the
# calls off the tuned widths (`is_wide`), `tiled_fwd_launches` and
# `tiled_bwd_launches` the calls that went to the tiled kernels); read by
# chip_smoke.py to show that a path went through them.
fwd_launches = 0
bwd_launches = 0
bwd_dh_only_launches = 0
wide_fwd_launches = 0
wide_bwd_launches = 0
tiled_fwd_launches = 0
tiled_bwd_launches = 0


def reset_launches() -> None:
    global fwd_launches, bwd_launches, bwd_dh_only_launches
    global wide_fwd_launches, wide_bwd_launches
    global tiled_fwd_launches, tiled_bwd_launches
    fwd_launches = 0
    bwd_launches = 0
    bwd_dh_only_launches = 0
    wide_fwd_launches = 0
    wide_bwd_launches = 0
    tiled_fwd_launches = 0
    tiled_bwd_launches = 0


def is_wide(dtype: torch.dtype, d: int) -> bool:
    """Whether width D is off the tuned widths (off D_STEP, or past
    MAX_D): in bf16 the wide kernels take it."""
    return d % D_STEP[op_dtype(dtype)] != 0 or d > MAX_D


def padded_width(d: int) -> int:
    """The width the bf16 wide K4 reads h and W at: d rounded up to a
    multiple of PAD_STEP (the wrapper stages zero-padded copies when it
    differs from d)."""
    return -(-d // PAD_STEP) * PAD_STEP


class WideBwdPlan(NamedTuple):
    """How csrc/ce_wide_bwd.cu cuts a padded width: its slabs of SLAB
    columns, the blocks of a cluster, the slabs a block owns, the slabs its
    first warpgroup holds (the kernels' NC), the ring's stages and a block's
    dynamic shared memory in bytes (the library's
    `deepsc_ce_wide_bwd_plan`)."""
    slabs: int
    cluster: int
    block_slabs: int
    nc: int
    stages: int
    smem: int


def wide_bwd_plan(dp: int) -> Optional[WideBwdPlan]:
    """The plan at padded width dp, or None where the tensor-core kernels
    do not take it (dp not a positive multiple of PAD_STEP, or more than
    MAX_CLUSTER x BLOCK_SLABS slabs)."""
    if dp <= 0 or dp % PAD_STEP:
        return None
    slabs = -(-dp // SLAB)
    cluster = -(-slabs // BLOCK_SLABS)
    if cluster > MAX_CLUSTER:
        return None
    block = -(-slabs // cluster)
    stage = block * TILE * 128 + 3 * TILE * 4
    fixed = 1024 + block * SLAB * 128 + 2 * SLAB * TILE * 4
    stages = min(MAX_STAGES, (SMEM_BUDGET - fixed) // stage)
    return WideBwdPlan(slabs, cluster, block, -(-block // 2), stages,
                       fixed + stages * stage)


class WideFwdPlan(NamedTuple):
    """How csrc/ce_wide_fwd.cu cuts a padded width: its k-chunks of SLAB
    columns, the ring's stages and a block's dynamic shared memory in
    bytes (the library's `deepsc_ce_wide_fwd_plan`)."""
    chunks: int
    stages: int
    smem: int


def wide_fwd_plan(dp: int) -> Optional[WideFwdPlan]:
    """The plan at padded width dp (a stage holds a k-chunk of h's 64 rows
    and of W's FWD_TILE rows, 128 bytes a row: the same shared memory at
    every width), or None off a positive multiple of PAD_STEP."""
    if dp <= 0 or dp % PAD_STEP:
        return None
    stage = (SLAB + FWD_TILE) * 128
    return WideFwdPlan(-(-dp // SLAB), FWD_STAGES,
                       1024 + FWD_STAGES * stage)


def uses_tensor_core_fwd(dtype: torch.dtype, d: int) -> bool:
    """Whether K3 at width d in `dtype` runs the wide tensor-core kernel
    (csrc/ce_wide_fwd.cu): bf16 off the tuned widths, any D; f32 runs the
    tiled kernel (`uses_tiled_fwd`)."""
    return op_dtype(dtype) == torch.bfloat16 and is_wide(dtype, d)


def uses_tensor_core_bwd(dtype: torch.dtype, d: int) -> bool:
    """Whether K4 at width d in `dtype` runs the wide tensor-core kernels
    (csrc/ce_wide_bwd.cu): bf16, off the tuned widths, and D up to
    MAX_CLUSTER x BLOCK_SLABS x SLAB; the f32 wide widths, and bf16 past
    5,120, run the tiled kernels (`uses_tiled_bwd`)."""
    return (op_dtype(dtype) == torch.bfloat16 and is_wide(dtype, d)
            and wide_bwd_plan(padded_width(d)) is not None)


def uses_tiled_fwd(dtype: torch.dtype, d: int) -> bool:
    """Whether K3 at width d in `dtype` runs the tiled kernel
    (csrc/ce_fwd_tiled.cu): every f32 width."""
    return op_dtype(dtype) == torch.float32


def uses_tiled_bwd(dtype: torch.dtype, d: int) -> bool:
    """Whether K4 at width d in `dtype` runs the tiled kernels
    (csrc/ce_bwd_tiled.cu): every f32 width, and bf16 past the 5,120
    columns of the tensor-core wide kernels."""
    return op_dtype(dtype) == torch.float32 or (
        is_wide(dtype, d) and not uses_tensor_core_bwd(dtype, d))


def tiled_workspace(n: int, v: int):
    """The shape of the tiled K4's P workspace: N and V rounded up to
    TILED_TILE (the P kernel writes its whole tiles, zeros past N and V)."""
    return (-(-n // TILED_TILE) * TILED_TILE,
            -(-v // TILED_TILE) * TILED_TILE)


def tiled_splits(n: int, d: int, v: int, sm_count: int,
                 blocks_per_sm: int) -> int:
    """Vocab splits of the tiled K4's dh product: the most whose blocks
    (row tiles x column tiles of D x splits) all fit in one wave of
    `blocks_per_sm` blocks per SM, at least one; every split owns at least
    one vocab tile (the library's condition). Its partials are added in
    split order."""
    tiles = -(-n // TILED_TILE) * -(-d // TILED_TILE)
    vt = -(-v // TILED_TILE)
    want = max(1, blocks_per_sm * sm_count // tiles)
    per = -(-vt // min(want, vt))
    return -(-vt // per)


def tiled_dw_splits(n: int, d: int, v: int, sm_count: int,
                    blocks_per_sm: int, most: int = 4) -> int:
    """Row splits of the tiled K4's dW product (its partials added in split
    order): one where its blocks (vocab tiles x column tiles of D) fill a
    wave of `blocks_per_sm` blocks per SM; else, of 1..`most`, each owning
    whole 128-row tiles of h, the one that takes the fewest waves times
    the row tiles a block sums, the fewest splits on a tie, and one unless
    that saves a tenth. (On an H100 80GB HBM3 at 700 W, three splits at
    D = 128 took the dW product from 0.398 to 0.283 ms; two at D = 200 and
    640, whose blocks already fill a wave, gained nothing and paid the
    partials' traffic: scripts/kernels_ab.py's device times by kernel.)"""
    rt = -(-n // TILED_TILE)
    blocks = -(-v // TILED_TILE) * -(-d // TILED_TILE)
    slots = max(1, blocks_per_sm * sm_count)
    if blocks >= slots:
        return 1

    def cost(s):
        return -(-blocks * s // slots) * -(-rt // s)

    best = min((s for s in range(1, min(most, rt) + 1)
                if (s - 1) * -(-rt // s) < rt), key=cost)
    return best if cost(best) <= 0.9 * cost(1) else 1


def tiled_split_ranges(total: int, splits: int):
    """[(first, last) index of each split] of `total` entries cut into
    whole tiles of TILED_TILE, split s from s x ceil(tiles / splits) of
    them, within `total` rounded up to TILED_TILE: the vocab splits of the
    tiled K4's dh product and of the tiled K3, and the row splits of the
    tiled K4's dW product."""
    tiles = -(-total // TILED_TILE)
    per = -(-tiles // splits)
    return [(s * per * TILED_TILE, min((s + 1) * per, tiles) * TILED_TILE)
            for s in range(splits)]


def op_dtype(dtype: torch.dtype) -> torch.dtype:
    """Matmul operand dtype for activations of `dtype`: bf16 for bf16,
    else f32."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _operands(h, W, b, labels):
    od = op_dtype(h.dtype)
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


def ce_bwd_reference(h, W, b, labels, lse, g, softmax_only=False,
                     dh_only=False):
    """Plain PyTorch version of K4: P = exp(logits - lse) g - onehot g;
    dh = Pc W, dW = Pc^T h with Pc = P rounded to the op dtype; db =
    sum_n P. -> (dh (N, D), dW (V, D), db (V,)), all f32; with `dh_only`,
    (dh, None, None). `softmax_only` leaves the label term out of P: the
    softmax part of the gradients, which checks hold on its own scale
    (beside the label term it is small).

    In f32, P in f32. Rounded to bf16, P is formed in f64 (f64 logits of
    the bf16 operands, less lse) and rounded through f32, so Pc is P
    correctly rounded: formed in f32, P rounds to the other bf16 neighbour
    wherever its f32 error crosses a rounding boundary, and on chip_smoke's
    inputs at D = 640 that put this version 2.5e-3 of the softmax part off
    an f64 evaluation where the kernel was 9.4e-4 off it (H100,
    scripts/ce_softmax_gate.py, PERF.md)."""
    h, W, b, labels = _operands(h, W, b, labels)
    f32 = h.dtype == torch.float32
    wide = torch.float32 if f32 else torch.float64
    g = g.to(wide)
    logits = (_logits(h, W, b) if f32 else
              torch.matmul(h.double(), W.double().t()) + b.double())
    p = torch.exp(logits - lse.to(wide)[:, None]) * g[:, None]
    if not softmax_only:
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows, labels.long()] -= g
    pc = p.float().to(h.dtype).float()
    if dh_only:
        return pc @ W.float(), None, None
    return pc @ W.float(), pc.t() @ h.float(), p.sum(dim=0).float()


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_POINTERS = {KERNEL_FWD: 7, KERNEL_BWD: 10}
_BOUND = {}
_TILING = {}


def _bind(kernel, dtype):
    """(launch function, shared-memory size function) of the built
    library of the tuned bf16 kernel `kernel`, with their ctypes
    signatures declared."""
    if (kernel, dtype) not in _BOUND:
        lib = build.load(kernel)
        fn = getattr(lib, f"deepsc_{kernel}_{_SUFFIX[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * _POINTERS[kernel]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"deepsc_{kernel}_smem_bytes_{_SUFFIX[dtype]}")
        smem.argtypes = [ctypes.c_int]
        smem.restype = ctypes.c_size_t
        _BOUND[(kernel, dtype)] = (fn, smem)
    return _BOUND[(kernel, dtype)]


def _bind_wide_bwd():
    """The bf16 tensor-core wide K4's launch function (csrc/ce_wide_bwd.cu),
    with its ctypes signature declared."""
    key = (KERNEL_WIDE_BWD, torch.bfloat16)
    if key not in _BOUND:
        fn = build.load(KERNEL_WIDE_BWD).deepsc_ce_wide_bwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def _bind_wide_fwd():
    """The bf16 tensor-core wide K3's launch function (csrc/ce_wide_fwd.cu),
    with its ctypes signature declared (the tuned entry's arguments, D the
    padded width)."""
    key = (KERNEL_WIDE_FWD, torch.bfloat16)
    if key not in _BOUND:
        fn = build.load(KERNEL_WIDE_FWD).deepsc_ce_wide_fwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * _POINTERS[KERNEL_FWD]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def library_plan(dp: int, kernel: str = KERNEL_WIDE_BWD):
    """`wide_bwd_plan(dp)` (or, for KERNEL_WIDE_FWD, `wide_fwd_plan(dp)`)
    as the built library computes it."""
    plan = WideFwdPlan if kernel == KERNEL_WIDE_FWD else WideBwdPlan
    fn = getattr(build.load(kernel), f"deepsc_{kernel}_plan")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(plan._fields))()
    err = fn(dp, out)
    if err != 0:
        raise ValueError(f"{kernel} does not take width {dp}: CUDA "
                         f"error {err}")
    return plan(*out)


def _bind_tiled_fwd():
    """The tiled K3's launch function (csrc/ce_fwd_tiled.cu), with its
    ctypes signature declared (the tuned entry's arguments)."""
    key = (KERNEL_FWD_TILED, torch.float32)
    if key not in _BOUND:
        fn = build.load(KERNEL_FWD_TILED).deepsc_ce_fwd_tiled_f32
        fn.argtypes = ([ctypes.c_void_p] * _POINTERS[KERNEL_FWD]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def _bind_tiled_bwd(dtype):
    """The tiled K4's launch function in `dtype` (csrc/ce_bwd_tiled.cu),
    with its ctypes signature declared (the tuned entry's pointers, then the
    P workspace, the dh partials and the dW/db partials; N, D, V, the vocab
    splits and the row splits)."""
    key = (KERNEL_BWD_TILED, dtype)
    if key not in _BOUND:
        fn = getattr(build.load(KERNEL_BWD_TILED),
                     f"deepsc_{KERNEL_BWD_TILED}_{_SUFFIX[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * (_POINTERS[KERNEL_BWD] + 2)
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def tiling(kernel, dtype, d, device):
    """(rows of h per tile, vocab rows per tile, blocks per SM) of the
    kernel in the library `kernel` (`ce_fwd`, `ce_bwd`, `ce_fwd_tiled`,
    `ce_bwd_tiled`, `ce_wide_fwd` or `ce_wide_bwd` (d: the padded width),
    or K6's `topk`,
    `topk_select` or `topk_wide_mma` (d: the list length k, its tiling the
    same at every width))
    that takes the vocab splits, at width d on
    `device`, as the library's
    `deepsc_<kernel>_tiling_<dtype>` reports them (the blocks from CUDA's
    occupancy calculator)."""
    key = (kernel, dtype, d, device)
    if key not in _TILING:
        fn = getattr(build.load(kernel),
                     f"deepsc_{kernel}_tiling_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            err = fn(d, out)
        if err != 0:
            raise RuntimeError(f"{kernel} tiling at D {d}: CUDA error {err}")
        _TILING[key] = tuple(out)
    return _TILING[key]


def _on_cuda(h):
    """True for a CUDA tensor on the current device, False for a CPU
    tensor; raises for anything else."""
    if h.device.type == "cpu":
        return False
    if h.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA, not {h.device}")
    if h.device.index != torch.cuda.current_device():
        raise ValueError(f"h is on {h.device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return True


def _check(h, W, b, labels, *rows):
    """What the kernels take: h (N, D) and W (V, D) of one dtype, f32 or
    bf16, any D >= 1 (the tuned bf16 kernels a multiple of 16 up to 256,
    the wide and the tiled kernels any other); b (V,) f32; int32 labels
    and f32 per-row vectors (N,); all contiguous, 16-byte aligned, on h's
    device."""
    if h.dtype not in _SUFFIX or W.dtype != h.dtype:
        raise TypeError(f"CE kernels take h and W of one dtype, float32 or "
                        f"bfloat16, not {h.dtype} and {W.dtype}")
    if h.dim() != 2 or W.dim() != 2 or W.shape[1] != h.shape[1] \
            or h.shape[1] < 1:
        raise ValueError(f"bad shapes h {tuple(h.shape)} W {tuple(W.shape)}"
                         f" (want (N, D) and (V, D), D >= 1)")
    n = h.shape[0]
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


def vocab_splits(n: int, v: int, sm_count: int, rows: int, vocab_rows: int,
                 blocks_per_sm: int) -> int:
    """Vocab ranges the row tiles (`rows` rows of h each) are cut into: the
    most whose blocks (row tiles x ranges) all fit in one wave of
    `blocks_per_sm` blocks per SM, at least one; every range owns at least
    one vocab tile of `vocab_rows` rows."""
    tiles = math.ceil(v / vocab_rows)
    want = max(1, blocks_per_sm * sm_count // math.ceil(n / rows))
    per = math.ceil(tiles / min(want, tiles))
    return math.ceil(tiles / per)


def _launch_setup(kernel, h, W):
    """(launch function, vocab splits) of the tuned bf16 kernel `kernel`
    for h and W."""
    (n, d), v = h.shape, W.shape[0]
    props = torch.cuda.get_device_properties(h.device)
    fn, smem_bytes = _bind(kernel, h.dtype)
    smem = smem_bytes(d)
    if smem > props.shared_memory_per_block_optin:
        raise ValueError(f"{kernel} kernel needs {smem} bytes of shared "
                         f"memory per block; the device allows "
                         f"{props.shared_memory_per_block_optin}")
    splits = vocab_splits(n, v, props.multi_processor_count,
                          *tiling(kernel, h.dtype, d, h.device))
    return fn, splits


def ce_fwd(h, W, b, labels):
    """K3's wrapper: -> (ce, lse), both (N,) f32."""
    if not _on_cuda(h):
        return ce_fwd_reference(h, W, b, labels)
    h, W, b, labels = _operands(h, W, b, labels)
    _check(h, W, b, labels)
    (n, d), v = h.shape, W.shape[0]
    wide, tiled = is_wide(h.dtype, d), uses_tiled_fwd(h.dtype, d)
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    if tiled:
        fn = _bind_tiled_fwd()
        splits = vocab_splits(n, v, sms, *tiling(KERNEL_FWD_TILED, h.dtype,
                                                 d, h.device))
    elif uses_tensor_core_fwd(h.dtype, d):
        d = padded_width(d)
        fn = _bind_wide_fwd()
        splits = vocab_splits(n, v, sms, *tiling(KERNEL_WIDE_FWD, h.dtype, d,
                                                 h.device))
        h, W = _padded(h, d), _padded(W, d)
    else:
        fn, splits = _launch_setup(KERNEL_FWD, h, W)
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
    global fwd_launches, wide_fwd_launches, tiled_fwd_launches
    fwd_launches += 1
    wide_fwd_launches += wide
    tiled_fwd_launches += tiled
    return ce, lse


def _padded(x, dp):
    """x (rows, d) as a zero-padded copy of width dp (x itself when d ==
    dp)."""
    rows, d = x.shape
    if d == dp:
        return x
    out = torch.empty((rows, dp), dtype=x.dtype, device=x.device)
    out[:, d:].zero_()
    out[:, :d].copy_(x)
    return out


def ce_bwd(h, W, b, labels, lse, g, dh_only=False):
    """K4's wrapper: -> (dh (N, D), dW (V, D), db (V,)), all f32; with
    `dh_only`, (dh, None, None) from the dh kernel alone."""
    if not _on_cuda(h):
        return ce_bwd_reference(h, W, b, labels, lse, g, dh_only=dh_only)
    h, W, b, labels = _operands(h, W, b, labels)
    lse = lse.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    _check(h, W, b, labels, lse, g)
    (n, d), v = h.shape, W.shape[0]
    tensor_cores = uses_tensor_core_bwd(h.dtype, d)
    tiled = uses_tiled_bwd(h.dtype, d)
    f32 = {"dtype": torch.float32, "device": h.device}
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    if tensor_cores:
        dp = padded_width(d)
        plan = wide_bwd_plan(dp)
        fn = _bind_wide_bwd()
        splits = vocab_splits(n, v, max(1, sms // plan.cluster),
                              *tiling(KERNEL_WIDE_BWD, h.dtype, dp, h.device))
        h, W = _padded(h, dp), _padded(W, dp)
    elif tiled:
        fn = _bind_tiled_bwd(h.dtype)
        blocks = tiling(KERNEL_BWD_TILED, h.dtype, d, h.device)[2]
        splits = tiled_splits(n, d, v, sms, blocks)
        dw_splits = 1 if dh_only else tiled_dw_splits(n, d, v, sms, blocks)
        # P once, (N, V) rounded up to whole tiles
        work = torch.empty(tiled_workspace(n, v), **f32)
        dw_part = (torch.empty(dw_splits * (v * d + v), **f32)
                   if dw_splits > 1 else None)
    else:
        fn, splits = _launch_setup(KERNEL_BWD, h, W)
    dh = torch.empty((n, d), **f32)
    dW = None if dh_only else torch.empty((v, d), **f32)
    db = None if dh_only else torch.empty(v, **f32)
    dh_part = (torch.empty((splits, n, d), **f32)
               if splits > 1 or not tiled else None)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    sizes = ((n, d, dp, v, splits) if tensor_cores else
             (n, d, v, splits, dw_splits) if tiled else (n, d, v, splits))
    pointers = [h, W, b, labels, lse, g, dh, dW, db] + (
        [work, dh_part, dw_part] if tiled else [dh_part])
    err = fn(*(None if t is None else t.data_ptr() for t in pointers),
             *sizes, stream)
    if err != 0:
        raise RuntimeError(f"CE backward kernel launch failed: CUDA error "
                           f"{err}")
    global bwd_launches, bwd_dh_only_launches, wide_bwd_launches
    global tiled_bwd_launches
    bwd_launches += 1
    bwd_dh_only_launches += dh_only
    wide_bwd_launches += is_wide(h.dtype, d)
    tiled_bwd_launches += tiled
    return dh, dW, db


class SoftmaxXent(torch.autograd.Function):
    """Per-row CE: forward K3, backward K4 (or both plain versions when
    `plain`), saving h, W, b, labels and lse as the TPU package's custom
    VJP does; K4 in its dh-only mode when neither W nor b needs a
    gradient."""

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
        dh_only = not (ctx.needs_input_grad[1] or ctx.needs_input_grad[2])
        dh, dW, db = bwd(h, W, b, labels, lse, g, dh_only=dh_only)
        if dh_only:
            return dh.to(h.dtype), None, None, None, None
        return dh.to(h.dtype), dW.to(W.dtype), db.to(b.dtype), None, None


def softmax_xent(h, W, b, labels, plain: bool = False):
    """(N,) f32 per-row CE of h (N, D) against the vocab table W (V, D) and
    bias b (V,); see the module docstring."""
    return SoftmaxXent.apply(h, W, b, labels, plain)
