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
checks need (the 128 x 128 tile of the f32 K3 and K4, `csrc/ce_tiled.cuh`).
Past k = 8, or at a width off its step, the wide kernels
take the call: in bf16 up to k = K_LIST the tensor-core wide kernel
(`csrc/topk_wide_mma.cu`: the wide K3's streamed wgmma logits tile; up to
K_SHORT each row's k best kept in shared memory behind a threshold filter,
then a merge of the vocab splits; past it the long path: lists of
SELECT_LIST a split, a per-row bound from their union, the logits again
with the keys at or above it kept, and a select of each row's k best);
every f32 call, and bf16 past K_LIST or past the long path's vocab, the
select kernels (`csrc/topk_select.cu`: the logits once into an (N, V) f32
workspace, f32 on the CUDA cores and bf16 on the tensor cores, then a
block per row radix-selects its k best keys and sorts them, any k up to
V). The vocab splits come from `ce_kernel.vocab_splits` fed by the
library's tiles and blocks per SM (`deepsc_topk_tiling_*`,
`deepsc_topk_select_tiling_*`, `deepsc_topk_wide_mma_tiling_bf16`).

`take_top` is the selection both use, and beam search's second stage too:
k rounds of (max, lowest index reaching the max), each winner masked to
NEG. `torch.topk` is not used: its order on ties is not specified.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from deepsc_gan_tpu_torch.ops import build
from deepsc_gan_tpu_torch.ops.ce_kernel import (
    MAX_D,
    _on_cuda,
    _padded,
    op_dtype,
    padded_width,
    tiling,
    vocab_splits,
)

KERNEL = "topk"
KERNEL_SELECT = "topk_select"
KERNEL_WIDE_MMA = "topk_wide_mma"
NEG = -1e30
IBIG = 2 ** 30
# what the tuned kernel takes: k up to MAX_K (a sorted list of at most 8 a
# row in registers), D a multiple of D_STEP up to ce_kernel.MAX_D; any
# other k <= V or D >= 1 goes to the wide kernels (the bf16 tensor-core
# wide kernel below, or the select kernels of csrc/topk_select.cu)
MAX_K = 8
D_STEP = 8
# the bf16 tensor-core wide kernel (csrc/topk_wide_mma.cu): k up to K_LIST,
# up to K_SHORT each row's list LIST_LENGTHS long (the first that holds k),
# past it the long path's lists of SELECT_LIST (V up to LONG_MAX_V); a
# ring of MMA_STAGES stages of a 64-column k-chunk of h's 64 rows and of
# W's MMA_TILE rows (128 bytes a row), and MMA_BUF candidate keys a row a
# round; the list and the buffer of each of a block's 64 rows (and one key
# of padding), 8 bytes a key. The long path's threshold stages the
# splits' lists of SELECT_LIST in MERGE_SMEM bytes at most, its select a
# row's candidates (at most CAND_CAP a row and CAND_BUDGET bytes over the
# rows) and k best.
K_LIST = 256
K_SHORT = 64
LIST_LENGTHS = (16, 32, 64)
SELECT_LIST = 16
LONG_MAX_V = 25000
MMA_STAGES = 2
MMA_TILE = 128
MMA_BUF = 32
MERGE_SMEM = 200 * 1024
CAND_CAP = 4096
CAND_BUDGET = 64 * 2 ** 20
# the select kernel's shared memory beside a row's keys: its candidate
# buffer (4,096 keys) and its static part
SELECT_RESERVED = 8 * 4096 + 2048

# Launches of K6 since the last reset (the wrapper adds one per launch and
# nowhere else; `wide_launches` counts the calls among them that went to
# the wide kernels, `long_list_launches` those that went to the
# tensor-core wide kernel's long path, past k = K_SHORT,
# `select_launches` those that went to the select kernels and
# `tiled_launches` the f32 calls of the tuned kernel, on the 128 x 128
# tile); read by chip_smoke.py to show that a path went through it.
launches = 0
wide_launches = 0
long_list_launches = 0
select_launches = 0
tiled_launches = 0


def reset_launches() -> None:
    global launches, wide_launches, long_list_launches, select_launches
    global tiled_launches
    launches = 0
    wide_launches = 0
    long_list_launches = 0
    select_launches = 0
    tiled_launches = 0


def uses_long_list(dtype: torch.dtype, d: int, k: int, v: int) -> bool:
    """Whether K6 at width d and k in `dtype` over V = v rows of W runs the
    tensor-core wide kernel's long path (bf16, k from K_SHORT + 1 to
    K_LIST, V up to LONG_MAX_V)."""
    return uses_tensor_core(dtype, d, k, v) and k > K_SHORT


def is_wide(d: int, k: int) -> bool:
    """Whether width D and k go to the wide kernels."""
    return k > MAX_K or d % D_STEP != 0 or d > MAX_D


def uses_tensor_core(dtype: torch.dtype, d: int, k: int, v: int) -> bool:
    """Whether K6 at width d and k in `dtype` over V = v rows of W runs the
    tensor-core wide kernel (csrc/topk_wide_mma.cu): bf16
    calls the tuned kernel does not take, k up to K_LIST (past K_SHORT its
    long path, V up to LONG_MAX_V); f32, longer lists and larger vocabs
    past K_SHORT run the select kernels (`uses_select`)."""
    return (op_dtype(dtype) == torch.bfloat16 and is_wide(d, k)
            and k <= K_LIST
            and (k <= K_SHORT or takes_long(k, v)))


def select_keys_spill(k: int, smem_optin: int) -> bool:
    """Whether the select kernel keeps a row's k keys in the caller's
    scratch (N, k) rather than in its block's shared memory: where 8 k
    bytes do not fit beside SELECT_RESERVED bytes of the card's
    `smem_optin` (csrc/topk_select.cu `select_plan`; the H100's 227 KB
    hold the keys of k up to 24,704)."""
    return 8 * k > smem_optin - SELECT_RESERVED


def uses_select(dtype: torch.dtype, d: int, k: int, v: int) -> bool:
    """Whether K6 at width d and k in `dtype` over V = v rows of W runs the
    select kernels (csrc/topk_select.cu): every call of the wide kernels
    that the tensor-core wide kernel does not take (every f32 one; bf16
    past K_LIST, or past K_SHORT where the long path does not take V)."""
    return is_wide(d, k) and not uses_tensor_core(dtype, d, k, v)


def takes_long(k: int, v: int) -> bool:
    """Whether the long path takes k over V vocab rows: V up to
    LONG_MAX_V, and vocab tiles enough that all but the last fill lists of
    SELECT_LIST holding 2 k keys."""
    return v <= LONG_MAX_V and (-(-v // MMA_TILE) - 1) * SELECT_LIST >= 2 * k


class WideMmaPlan(NamedTuple):
    """How csrc/topk_wide_mma.cu takes k: its list length, the ring's
    stages and a block's dynamic shared memory in bytes (the library's
    `deepsc_topk_wide_mma_plan`)."""
    list_length: int
    stages: int
    smem: int


def wide_mma_plan(k: int) -> Optional[WideMmaPlan]:
    """The plan for k (the same at every width; past K_SHORT the long
    path's partial kernel, lists of SELECT_LIST), or None outside
    1..K_LIST: 1,024 bytes of alignment, the ring, and per row of the
    block's 64 the list, the buffer and a key of padding."""
    if not 1 <= k <= K_LIST:
        return None
    length = next((n for n in LIST_LENGTHS if k <= n), SELECT_LIST)
    ring = MMA_STAGES * (64 + MMA_TILE) * 128
    keys = 64 * (length + MMA_BUF + 1)
    return WideMmaPlan(length, MMA_STAGES, 1024 + ring + 8 * keys)


class LongPlan(NamedTuple):
    """How the long path takes a call: the partial kernel's vocab splits,
    the emission's, and each row's candidate slots."""
    splits: int
    emit_splits: int
    cap: int


def long_plan(n: int, v: int, k: int, sms: int, tiles: tuple,
              emit_tiles: tuple) -> LongPlan:
    """The long path's plan for N rows, V vocab rows and k on `sms` SMs,
    from the partial kernel's tiling at lists of SELECT_LIST (`tiles`) and
    the emission's (`emit_tiles`): the partial kernel's splits as
    `vocab_splits` cuts them but at least enough that every split but the
    last fills its list and their union holds 2 k keys (`takes_long`: the
    vocab has tiles enough), their lists within the threshold's MERGE_SMEM
    bytes, each split owning `per` vocab tiles and the last at least one
    (the library refuses a count with an empty split); a row's candidate
    slots CAND_CAP, fewer where N rows of them would pass CAND_BUDGET
    bytes, but at least 2 k (a row with more candidates takes the
    fallback)."""
    vtiles = -(-v // tiles[1])
    want = min(max(vocab_splits(n, v, sms, *tiles),
                   -(-2 * k // SELECT_LIST) + 1), vtiles,
               MERGE_SMEM // (8 * SELECT_LIST))
    # fewer tiles a split until the splits that own them are enough (at
    # one tile a split there are vtiles, which `takes_long` makes enough)
    per = -(-vtiles // want)
    while per > 1 and (-(-vtiles // per) - 1) * SELECT_LIST < 2 * k:
        per -= 1
    cap = min(CAND_CAP, max(2 * k, CAND_BUDGET // (8 * n)))
    return LongPlan(-(-vtiles // per), vocab_splits(n, v, sms, *emit_tiles),
                    cap)


def library_plan(k: int) -> WideMmaPlan:
    """`wide_mma_plan(k)` as the built library computes it."""
    fn = build.load(KERNEL_WIDE_MMA).deepsc_topk_wide_mma_plan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(WideMmaPlan._fields))()
    err = fn(k, out)
    if err != 0:
        raise ValueError(f"{KERNEL_WIDE_MMA} does not take k = {k}: CUDA "
                         f"error {err}")
    return WideMmaPlan(*out)


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
    """The tuned library's launch function for `dtype`, with its ctypes
    signature declared."""
    if dtype not in _BOUND:
        fn = getattr(build.load(KERNEL), f"deepsc_topk_{_SUFFIX[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[dtype] = fn
    return _BOUND[dtype]


def _smem_bytes_bf16(d: int) -> int:
    """Dynamic shared memory of a block of the tuned bf16 kernel at width
    d, as the built library computes it (the f32 kernel has only static
    shared memory)."""
    fn = build.load(KERNEL).deepsc_topk_smem_bytes_bf16
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_size_t
    return fn(d)


def _bind_select(dtype):
    """The select library's launch function for `dtype`, with its ctypes
    signature declared."""
    key = (KERNEL_SELECT, dtype)
    if key not in _BOUND:
        fn = getattr(build.load(KERNEL_SELECT),
                     f"deepsc_topk_select_{_SUFFIX[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def _bind_long():
    """The long path's launch function, with its ctypes signature
    declared."""
    key = (KERNEL_WIDE_MMA, "long")
    if key not in _BOUND:
        fn = build.load(KERNEL_WIDE_MMA).deepsc_topk_wide_mma_long_bf16
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


_EMIT_TILING = {}


def emit_tiling(device) -> tuple:
    """(rows of h per tile, vocab rows per tile, blocks an SM) of the long
    path's emission kernel, as the built library reports them."""
    if device not in _EMIT_TILING:
        fn = build.load(KERNEL_WIDE_MMA).deepsc_topk_wide_mma_emit_tiling_bf16
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            err = fn(out)
        if err != 0:
            raise RuntimeError(f"{KERNEL_WIDE_MMA} emission tiling: CUDA "
                               f"error {err}")
        _EMIT_TILING[device] = tuple(out)
    return _EMIT_TILING[device]


def _bind_wide_mma():
    """The tensor-core wide library's launch function, with its ctypes
    signature declared."""
    key = (KERNEL_WIDE_MMA, torch.bfloat16)
    if key not in _BOUND:
        fn = build.load(KERNEL_WIDE_MMA).deepsc_topk_wide_mma_bf16
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def _check(h, W, b, k):
    """What the kernels take: h (N, D) and W (V, D) of one dtype, f32 or
    bf16, any D >= 1; b (V,) f32; 1 <= k <= V; all contiguous, 16-byte
    aligned, on h's device."""
    if h.dtype not in _SUFFIX or W.dtype != h.dtype:
        raise TypeError(f"K6 takes h and W of one dtype, float32 or "
                        f"bfloat16, not {h.dtype} and {W.dtype}")
    if h.dim() != 2 or W.dim() != 2 or W.shape[1] != h.shape[1] \
            or h.shape[1] < 1:
        raise ValueError(f"bad shapes h {tuple(h.shape)} W {tuple(W.shape)}"
                         f" (want (N, D) and (V, D), D >= 1)")
    v = W.shape[0]
    if not 1 <= k <= v:
        raise ValueError(f"k {k}: K6 takes 1 <= k <= V = {v}")
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
    (n, d), v = h.shape, W.shape[0]
    dev = h.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    wide = is_wide(d, k)
    long = uses_long_list(h.dtype, d, k, v)
    select = uses_select(h.dtype, d, k, v)
    launch = (_launch_long if long
              else _launch_select if select
              else _launch_wide_mma if wide
              else _launch)
    err = launch(h, W, b, k, vals, idx, lse, stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {err}")
    global launches, wide_launches, long_list_launches, select_launches
    global tiled_launches
    launches += 1
    wide_launches += wide
    long_list_launches += long
    select_launches += select
    tiled_launches += not wide and h.dtype == torch.float32
    return vals, idx, lse


def _launch(h, W, b, k, vals, idx, lse, stream):
    """The tuned kernel on checked operands; -> the CUDA error code."""
    (n, d), v = h.shape, W.shape[0]
    dev = h.device
    props = torch.cuda.get_device_properties(dev)
    if h.dtype == torch.bfloat16 and \
            _smem_bytes_bf16(d) > props.shared_memory_per_block_optin:
        raise ValueError(f"K6 needs {_smem_bytes_bf16(d)} bytes of shared "
                         f"memory per block; the device allows "
                         f"{props.shared_memory_per_block_optin}")
    splits = vocab_splits(n, v, props.multi_processor_count,
                          *tiling(KERNEL, h.dtype, d, dev))
    part_v = torch.empty((splits, n, MAX_K), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((splits, n, MAX_K), dtype=torch.int32, device=dev)
    part_ms = torch.empty((splits, n, 2), dtype=torch.float32, device=dev)
    return _bind(h.dtype)(
        h.data_ptr(), W.data_ptr(), b.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), lse.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
        part_ms.data_ptr(), n, d, v, k, splits, stream)


def _launch_select(h, W, b, k, vals, idx, lse, stream):
    """The select kernels on checked operands (bf16: D off 8 columns
    through zero-padded copies of width dp); -> the CUDA error code."""
    (n, d), v = h.shape, W.shape[0]
    if h.dtype == torch.bfloat16:
        d = padded_width(d)
        h, W = _padded(h, d), _padded(W, d)
    dev = h.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = vocab_splits(n, v, sms, *tiling(KERNEL_SELECT, h.dtype, d, dev))
    # the (N, V) f32 logits, written once and read by the select; each
    # split's (max, sum) a row; the rows' k keys where a block's shared
    # memory does not hold them (the library's rule)
    logits = torch.empty((n, v), dtype=torch.float32, device=dev)
    part_ms = torch.empty((splits, n, 3), dtype=torch.float32, device=dev)
    optin = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    scratch = torch.empty((n, k) if select_keys_spill(k, optin) else (1,),
                          dtype=torch.int64, device=dev)
    return _bind_select(h.dtype)(
        h.data_ptr(), W.data_ptr(), b.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), lse.data_ptr(), logits.data_ptr(),
        part_ms.data_ptr(), scratch.data_ptr(), n, d, v, k, splits, stream)


def _launch_wide_mma(h, W, b, k, vals, idx, lse, stream):
    """The tensor-core wide kernel on checked bf16 operands (D off 8
    columns through zero-padded copies of width dp); -> the CUDA error
    code."""
    (n, d), v = h.shape, W.shape[0]
    dp = padded_width(d)
    h, W = _padded(h, dp), _padded(W, dp)
    dev = h.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the library's tiling takes k in the place of a width
    splits = vocab_splits(n, v, sms, *tiling(KERNEL_WIDE_MMA, h.dtype, k,
                                             dev))
    part_key = torch.empty((n, splits, k), dtype=torch.int64, device=dev)
    part_ms = torch.empty((splits, n, 3), dtype=torch.float32, device=dev)
    # each row's threshold, shared by its splits (the largest k-th key a
    # split has published), from zero
    row_kth = torch.zeros(n, dtype=torch.int64, device=dev)
    return _bind_wide_mma()(
        h.data_ptr(), W.data_ptr(), b.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), lse.data_ptr(), part_key.data_ptr(),
        part_ms.data_ptr(), row_kth.data_ptr(), n, dp, v, k, splits, stream)


def _launch_long(h, W, b, k, vals, idx, lse, stream):
    """The tensor-core wide kernel's long path on checked bf16 operands (D
    off 8 columns through zero-padded copies of width dp); -> the CUDA
    error code."""
    (n, d), v = h.shape, W.shape[0]
    dp = padded_width(d)
    h, W = _padded(h, dp), _padded(W, dp)
    dev = h.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = long_plan(n, v, k, sms, tiling(KERNEL_WIDE_MMA, h.dtype,
                                          SELECT_LIST, dev), emit_tiling(dev))
    part_key = torch.empty((n, plan.splits, SELECT_LIST), dtype=torch.int64,
                           device=dev)
    part_ms = torch.empty((plan.splits, n, 3), dtype=torch.float32,
                          device=dev)
    # each row's bound (prefix, mask), its candidates and their count (one
    # more count: the rows that overflowed, listed in `over`)
    row_thr = torch.empty((n, 2), dtype=torch.int64, device=dev)
    cand = torch.empty((n, plan.cap), dtype=torch.int64, device=dev)
    count = torch.empty(n + 1, dtype=torch.int32, device=dev)
    over = torch.empty(n, dtype=torch.int32, device=dev)
    return _bind_long()(
        h.data_ptr(), W.data_ptr(), b.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), lse.data_ptr(), part_key.data_ptr(),
        part_ms.data_ptr(), row_thr.data_ptr(), cand.data_ptr(),
        count.data_ptr(), over.data_ptr(), n, dp, v, k, plan.splits,
        plan.emit_splits, plan.cap, stream)
