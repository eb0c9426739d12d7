"""Fused multi-head attention: the CUDA kernels `csrc/attention_fwd.cu`
(K1, the port of the TPU kernel `_fwd_kernel`) and `csrc/attention_bwd.cu`
(K2, the port of `_bwd_kernel`, deepsc_gan_tpu/ops/pallas/attention.py),
bf16 at the tuned heads, with `csrc/attention_bwd_resident.cu` (the bf16 K2
past 32 queries or keys up to L_RES of both), `csrc/attention_bwd_cluster.cu`
(the bf16 K2 past L_RES up to L_CLUSTER), `csrc/attention_narrow.cu` (f32
K1 and K2 at the tuned heads, any length), `csrc/attention_wide_mma.cu`
(bf16, heads up to 256 wide), `csrc/attention_chunked.cu` (bf16, heads wider
than 256), `csrc/attention_tiled.cu` (the f32 K1) and
`csrc/attention_bwd_tiled.cu` (the f32 K2) for the head widths and counts
the tuned ones do not take, their wrappers and plain PyTorch versions, and
the `torch.autograd.Function` that joins them as the TPU package's custom
VJP does.

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
KERNEL_TILED = "attention_tiled"
KERNEL_BWD_TILED = "attention_bwd_tiled"
KERNEL_CHUNKED = "attention_chunked"
KERNEL_WIDE_MMA = "attention_wide_mma"
KERNEL_RESIDENT = "attention_bwd_resident"
KERNEL_CLUSTER = "attention_bwd_cluster"
KERNEL_NARROW = "attention_narrow"
# what the tuned kernels take: heads of a compile-time width in HEAD_DIMS,
# at most MAX_HEADS of them, any number of queries and keys. bf16 on
# csrc/attention_fwd.cu and csrc/attention_bwd.cu: a warp per head; up to
# TILE queries and keys a block per batch row, the row's q, k, v (and g)
# staged as bf16 in two 16-row mma m-tiles of queries and of keys, the
# forward's block holding a batch row's heads, the backward's four of them
# (all when dbias is asked for); past TILE of either the long-length
# kernels, a block per tile of TILE queries with the keys streamed in tiles
# of TILE (online softmax), and a backward in two kernels (dq and dbias per
# query tile, then dk and dv per key tile) that pass the softmax statistics
# through a scratch tensor. f32 on csrc/attention_narrow.cu (`uses_narrow`):
# a block of 128 threads per batch row, head and TILE queries (or keys), a
# quad of lanes per query, each lane a quarter of the keys of a tile and of
# the head's columns; the forward streams key tiles of TILE (one tile: an
# exact softmax, more: an online one); the backward up to TILE queries and
# keys one kernel a (row, head), past them a dq kernel and a dk/dv kernel
# through the (N, H, Lq, 4) statistics scratch; dbias through an (N, H, Lq,
# Lk) ds scratch summed over the heads by a last kernel.
# Any other head width, or more heads: the wide kernels. In bf16 at heads
# up to REGISTER_DH wide, the tensor-core wide kernels
# (csrc/attention_wide_mma.cu: mma.sync, the head zero-padded in shared
# memory to 16, 32, 64, 128 or 256 columns; the forward a block per row,
# head and 32 queries, the backward a block per row and head up to TILE
# queries and keys, past them a dq kernel and a dk/dv kernel that pass the
# statistics through the scratch); in f32 the forward on
# csrc/attention_tiled.cu (a block per row, head and 16 or 8 queries, the
# logits formed once into shared memory from cp.async-staged chunks of q
# and k, an exact softmax, then p v a chunk of output columns at a time),
# the backward on csrc/attention_bwd_tiled.cu (a block per row, head and
# 16 or 8 queries forming S and dP once into shared memory, p and dss
# written to a scratch, then dq; a block per row, head and 16 or 8 keys
# summing dk and dv from that scratch), any length. bf16
# at heads wider than REGISTER_DH: the tensor-core chunked kernels (csrc/attention_chunked.cu: mma.sync, the logits' k-steps
# split over a block's eight warps and their partials summed in shared
# memory; the forward a block per row, head, 16 queries and 512 output
# columns, the backward per row, head and 128 output columns up to TILE
# queries and keys, past them a dq and a dk/dv kernel through the
# statistics scratch).
# The bf16 K2 at those head widths and counts past TILE queries or keys, up
# to L_RES of both, runs the resident kernel
# (csrc/attention_bwd_resident.cu: a block per batch row and head holds the
# head's q, g, k, v and the row's bias tile, a warp per 16 queries forms p
# once over all keys, then a warp per 16 keys sums dk and dv over all
# queries). Past L_RES of either, up to L_CLUSTER of both, the cluster
# kernel (csrc/attention_bwd_cluster.cu: a block per row's head holds the
# head's k and v and walks its query slices, a warp per 16 queries and
# CLUSTER_CHUNK keys forming p once, dk and dv held in registers over the
# slices; where the rows' heads are fewer than the SMs, the slices are
# split over a cluster of up to CLUSTER_MAX blocks whose dk and dv
# partials are summed in rank order through distributed shared memory);
# the long-length kernels keep the longer rows.
HEAD_DIMS = (8, 16, 32)
MAX_HEADS = 16
TILE = 32
REGISTER_DH = 256
L_RES = 128
L_CLUSTER = 512
# the cluster kernel's block: CLUSTER_WARPS warps, each a phase-1 task of
# 16 queries and CLUSTER_CHUNK keys; at most CLUSTER_MAX blocks a cluster
CLUSTER_WARPS = 16
CLUSTER_CHUNK = 64
CLUSTER_MAX = 8
# the shared memory a block of the cluster kernel may take (the H100's)
CLUSTER_SMEM = 232448

# Launches of the forward (K1) and backward (K2) kernels since the last
# reset (each wrapper adds one per launch and nowhere else; `wide_launches`
# and `wide_bwd_launches` count the calls among them that went to the wide
# kernels, `tiled_launches` and `tiled_bwd_launches` the K1 and K2 calls
# that went to the tiled f32 kernels, `narrow_launches` and
# `narrow_bwd_launches` those that went to the narrow f32 kernels,
# `cluster_bwd_launches` the K2 calls that went to the cluster kernel);
# read by chip_smoke.py to show that a path went through the kernels.
launches = 0
bwd_launches = 0
wide_launches = 0
wide_bwd_launches = 0
tiled_launches = 0
tiled_bwd_launches = 0
narrow_launches = 0
narrow_bwd_launches = 0
cluster_bwd_launches = 0


def reset_launches() -> None:
    global launches, bwd_launches, wide_launches, wide_bwd_launches
    global tiled_launches, tiled_bwd_launches, cluster_bwd_launches
    global narrow_launches, narrow_bwd_launches
    launches = 0
    bwd_launches = 0
    wide_launches = 0
    wide_bwd_launches = 0
    tiled_launches = 0
    tiled_bwd_launches = 0
    narrow_launches = 0
    narrow_bwd_launches = 0
    cluster_bwd_launches = 0


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
# pointer arguments of each launch function: q, k, v, bias (, g) and the
# outputs (the long-length and wide backward entries also take the scratch)
_POINTERS = {KERNEL: 5, KERNEL_BWD: 9}
# the shared-memory size function of each library (bf16)
_SMEM = {KERNEL: "deepsc_attention_fwd_smem_bytes_bf16",
         KERNEL_BWD: "deepsc_attention_bwd_smem_bytes_bf16"}
_BOUND = {}


def is_long(lq: int, lk: int) -> bool:
    """Whether the long-length kernels take Lq x Lk (past TILE of
    either)."""
    return lq > TILE or lk > TILE


def uses_resident(dtype, lq: int, lk: int, heads: int, dh: int) -> bool:
    """Whether K2 at Lq x Lk and `heads` heads of `dh` in `dtype` runs the
    resident kernel (csrc/attention_bwd_resident.cu): bf16 at the tuned
    head widths and counts, past TILE queries or keys, up to L_RES of
    both. The cluster kernel takes these shapes too but is slower there
    (H100, N = 64, 8 heads of 16, no dbias: 0.0368 against 0.0349 ms at
    128 x 128, 0.0292 against 0.0101 at 63 x 64, 0.0305 against 0.0081 at
    33 x 33; scripts/attention_bwd_cluster_variants.py
    --against-resident)."""
    return (dtype == torch.bfloat16 and is_long(lq, lk) and lq <= L_RES
            and lk <= L_RES and not is_wide(heads, dh))


def uses_cluster(dtype, lq: int, lk: int, heads: int, dh: int) -> bool:
    """Whether K2 at Lq x Lk and `heads` heads of `dh` in `dtype` runs the
    cluster kernel (csrc/attention_bwd_cluster.cu): bf16 at the tuned head
    widths and counts, past L_RES queries or keys, up to L_CLUSTER of
    both."""
    return (dtype == torch.bfloat16 and (lq > L_RES or lk > L_RES)
            and lq <= L_CLUSTER and lk <= L_CLUSTER
            and not is_wide(heads, dh))


def cluster_slice_rows(lk: int) -> int:
    """Queries of a cluster K2 slice: a warp per 16 queries and key chunk
    (the keys cut into 1, 2, 4 or 8 chunks of CLUSTER_CHUNK), at most
    128."""
    chunks = -(-lk // CLUSTER_CHUNK)
    chunks = next(c for c in (1, 2, 4, 8) if chunks <= c)
    return 16 * min(CLUSTER_WARPS // chunks, 8)


def cluster_plan(lq: int, lk: int, dh: int):
    """(shared memory bytes, threads, query slices of a row's head, queries
    a slice) of the cluster K2 at Lq x Lk and head width dh (the library's
    `deepsc_attention_bwd_cluster_plan`): the head's k and v (Lk rounded up
    to 16 rows) and two buffers of a slice's q and g at an odd number of
    16-byte units a row, the slice's bias rows at Lk + 8 floats, the pc
    and dss tiles at 2 Lk + 16 bytes a row, each warp's row statistics (3
    x 16 f32), and the warps' dq partials (16 x dh f32 each) where the
    card's CLUSTER_SMEM allows (else they reuse the bias rows); the dk and
    dv partials (f32) of a cluster reuse
    the space after the last slice."""
    lkp = -(-lk // 16) * 16
    rows = cluster_slice_rows(lk)
    chunks = next(c for c in (1, 2, 4, 8) if -(-lk // CLUSTER_CHUNK) <= c)
    units = dh * 2 // 16
    stride = 16 * (units + (1 if units % 2 == 0 else 2))
    main = (2 * lkp * stride + 4 * rows * stride + 4 * rows * (lkp + 8)
            + 2 * rows * (2 * lkp + 16) + 4 * CLUSTER_WARPS * 16 * 3)
    own = main + 4 * rows * chunks * dh
    if own <= CLUSTER_SMEM:
        main = own
    return (max(main, 2 * lkp * dh * 4), 32 * CLUSTER_WARPS,
            -(-lq // rows), rows)


def cluster_size(n: int, heads: int, lq: int, lk: int, sms: int) -> int:
    """Blocks a cluster of the cluster K2 at N rows of `heads` heads on a
    card of `sms` SMs (the library's `deepsc_attention_bwd_cluster_size`):
    doubled from 1, up to CLUSTER_MAX and the query slices, while the rows'
    heads times it are fewer than the SMs."""
    slices = cluster_plan(lq, lk, 16)[2]
    c = 1
    while 2 * c <= CLUSTER_MAX and 2 * c <= slices and n * heads * c < sms:
        c *= 2
    return c


def resident_smem_bytes(lq: int, lk: int, dh: int) -> int:
    """Shared memory of a resident K2 block (the library's
    `deepsc_attention_bwd_resident_plan`): with the lengths rounded up to
    16, the head's q, g (Lq rows) and k, v (Lk rows) at an odd number of
    16-byte units a row, the bias tile at Lk + 8 floats a row, and the pc
    and dss tiles at 2 Lk + 16 bytes a row."""
    lqp, lkp = -(-lq // 16) * 16, -(-lk // 16) * 16
    units = dh * 2 // 16
    stride = 16 * (units + (1 if units % 2 == 0 else 2))
    return (2 * (lqp + lkp) * stride + 4 * lqp * (lkp + 8)
            + 2 * lqp * (2 * lkp + 16))


def resident_threads(lq: int, lk: int) -> int:
    """Threads of a resident K2 block: a warp per 16 of the longer side."""
    return 32 * -(-max(lq, lk) // 16)


def is_wide(heads: int, dh: int) -> bool:
    """Whether `heads` heads of width `dh` go to the wide kernels (a width
    outside HEAD_DIMS, or more than MAX_HEADS heads)."""
    return dh not in HEAD_DIMS or heads > MAX_HEADS


def is_chunked_mma(dtype, heads: int, dh: int) -> bool:
    """Whether K1 and K2 at `heads` heads of `dh` in `dtype` run the
    tensor-core chunked kernels (bf16, heads wider than REGISTER_DH)."""
    return dtype == torch.bfloat16 and is_wide(heads, dh) \
        and dh > REGISTER_DH


def uses_narrow(dtype, heads: int, dh: int) -> bool:
    """Whether K1 and K2 at `heads` heads of `dh` in `dtype` run the narrow
    f32 kernels (csrc/attention_narrow.cu): every f32 call at the tuned
    head widths and counts, at any length."""
    return dtype == torch.float32 and not is_wide(heads, dh)


def narrow_bwd_scratch_floats(n: int, lq: int, lk: int, heads: int,
                              need_dbias: bool) -> int:
    """f32 floats of the narrow K2's scratch (the library's
    `deepsc_attention_narrow_bwd_scratch_f32`): the row statistics (N, H,
    Lq, 4) past TILE queries or keys, then with dbias each head's ds (N,
    H, Lq, Lk), summed over the heads by its last kernel."""
    rows = n * heads * lq
    return 4 * rows * is_long(lq, lk) + rows * lk * need_dbias


def uses_tiled(dtype, heads: int, dh: int) -> bool:
    """Whether K1 and K2 at `heads` heads of `dh` in `dtype` run the tiled
    f32 kernels (csrc/attention_tiled.cu, csrc/attention_bwd_tiled.cu):
    every f32 call of the wide kernels, at any length."""
    return dtype == torch.float32 and is_wide(heads, dh)


def tiled_bwd_scratch_floats(n: int, lq: int, lk: int, heads: int,
                             need_dbias: bool) -> int:
    """f32 floats of the tiled K2's scratch: each head's p and dss (N, H,
    Lq, Lk), and its ds too where dbias is asked for (summed over the
    heads by the library's last kernel)."""
    return (3 if need_dbias else 2) * n * heads * lq * lk


def is_wide_mma(dtype, heads: int, dh: int) -> bool:
    """Whether K1 and K2 at `heads` heads of `dh` in `dtype` run the
    tensor-core wide kernels (bf16, wide, heads up to REGISTER_DH)."""
    return dtype == torch.bfloat16 and is_wide(heads, dh) \
        and dh <= REGISTER_DH


def takes_head_dim(dh: int) -> bool:
    """Whether some kernel takes heads of width `dh` (any width from 1)."""
    return dh >= 1


def _bind(kernel, long_bwd=False):
    """(launch function, shared-memory size function) of the built bf16
    library of `kernel` (with `long_bwd`, the backward's long-length entry,
    which also takes the statistics scratch), with their ctypes signatures
    declared."""
    key = (kernel, long_bwd)
    if key not in _BOUND:
        lib = build.load(kernel)
        entry = f"deepsc_{kernel}_long" if long_bwd else f"deepsc_{kernel}"
        fn = getattr(lib, f"{entry}_bf16")
        fn.argtypes = ([ctypes.c_void_p] * (_POINTERS[kernel] + long_bwd)
                       + [ctypes.c_int] * 5
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = getattr(lib, _SMEM[kernel])
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_size_t
        _BOUND[key] = (fn, smem)
    return _BOUND[key]


def _bind_narrow(kernel):
    """The narrow f32 library's launch function for `kernel`'s function
    (K1, or K2 with its scratch), with its ctypes signature declared."""
    key = (KERNEL_NARROW, kernel)
    if key not in _BOUND:
        part = "fwd" if kernel == KERNEL else "bwd"
        fn = getattr(build.load(KERNEL_NARROW),
                     f"deepsc_attention_narrow_{part}_f32")
        fn.argtypes = ([ctypes.c_void_p] * (_POINTERS[kernel]
                                            + (kernel == KERNEL_BWD))
                       + [ctypes.c_int] * 5
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def library_narrow_bwd_scratch_floats(n: int, lq: int, lk: int, heads: int,
                                      need_dbias: bool) -> int:
    """`narrow_bwd_scratch_floats` as the built library computes it."""
    fn = build.load(KERNEL_NARROW).deepsc_attention_narrow_bwd_scratch_f32
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn(n, lq, lk, heads, int(need_dbias))


def _bind_tiled_bwd():
    """The tiled f32 K2's launch function, with its ctypes signature
    declared (the backward's arguments, then its scratch)."""
    key = (KERNEL_BWD_TILED, KERNEL_BWD)
    if key not in _BOUND:
        fn = build.load(KERNEL_BWD_TILED).deepsc_attention_bwd_tiled_f32
        fn.argtypes = ([ctypes.c_void_p] * (_POINTERS[KERNEL_BWD] + 1)
                       + [ctypes.c_int] * 5
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def _bind_tiled():
    """(launch function, scratch-size function) of the tiled f32 K1, with
    their ctypes signatures declared (the forward's arguments and S's
    scratch)."""
    key = (KERNEL_TILED, KERNEL)
    if key not in _BOUND:
        lib = build.load(KERNEL_TILED)
        fn = lib.deepsc_attention_tiled_fwd_f32
        fn.argtypes = ([ctypes.c_void_p] * (_POINTERS[KERNEL] + 1)
                       + [ctypes.c_int] * 5
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        size = lib.deepsc_attention_tiled_scratch_f32
        size.argtypes = [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong)]
        size.restype = ctypes.c_int
        _BOUND[key] = (fn, size)
    return _BOUND[key]


_TILED_SCRATCH = {}


def tiled_scratch_floats(n: int, lq: int, lk: int, heads: int,
                         dh: int) -> int:
    """f32 floats of the scratch the tiled K1 needs for these shapes on the
    current device (0 where a block's logits fit its shared memory), as the
    built library computes them."""
    key = (n, lq, lk, heads, dh, torch.cuda.current_device())
    if key not in _TILED_SCRATCH:
        out = ctypes.c_longlong()
        err = _bind_tiled()[1](n, lq, lk, heads, dh, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"{KERNEL_TILED} scratch size: CUDA error "
                               f"{err}")
        _TILED_SCRATCH[key] = out.value
    return _TILED_SCRATCH[key]


def _bind_tensor_core(library, kernel):
    """The bf16 launch function for `kernel`'s function (K1 or K2) of a
    tensor-core wide library (KERNEL_WIDE_MMA or KERNEL_CHUNKED), with its
    ctypes signature declared (the wide entries' arguments; the backward's
    also take the statistics and dbias scratch)."""
    key = (library, kernel)
    if key not in _BOUND:
        part = "fwd" if kernel == KERNEL else "bwd"
        fn = getattr(build.load(library), f"deepsc_{library}_{part}_bf16")
        fn.argtypes = ([ctypes.c_void_p] * (_POINTERS[kernel]
                                            + 2 * (kernel == KERNEL_BWD))
                       + [ctypes.c_int] * 5
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def _bind_resident():
    """The resident K2's launch function, with its ctypes signature
    declared (the backward's arguments, then the dbias scratch)."""
    key = (KERNEL_RESIDENT, KERNEL_BWD)
    if key not in _BOUND:
        fn = build.load(KERNEL_RESIDENT).deepsc_attention_bwd_resident_bf16
        fn.argtypes = ([ctypes.c_void_p] * (_POINTERS[KERNEL_BWD] + 1)
                       + [ctypes.c_int] * 5
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def _bind_cluster():
    """The cluster K2's launch function, with its ctypes signature
    declared (the resident K2's arguments)."""
    key = (KERNEL_CLUSTER, KERNEL_BWD)
    if key not in _BOUND:
        fn = build.load(KERNEL_CLUSTER).deepsc_attention_bwd_cluster_bf16
        fn.argtypes = ([ctypes.c_void_p] * (_POINTERS[KERNEL_BWD] + 1)
                       + [ctypes.c_int] * 5
                       + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return _BOUND[key]


def library_cluster_plan(lq: int, lk: int, dh: int):
    """`cluster_plan(lq, lk, dh)` as the built library reports it."""
    fn = build.load(KERNEL_CLUSTER).deepsc_attention_bwd_cluster_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(lq, lk, dh, out)
    if err != 0:
        raise ValueError(f"{KERNEL_CLUSTER} does not take {lq} x {lk} at "
                         f"head width {dh}: CUDA error {err}")
    return tuple(out)


def library_cluster_size(n: int, heads: int, lq: int, lk: int) -> int:
    """`cluster_size` on the current device, as the built library computes
    it."""
    fn = build.load(KERNEL_CLUSTER).deepsc_attention_bwd_cluster_size
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int()
    err = fn(n, heads, lq, lk, ctypes.byref(out))
    if err != 0:
        raise ValueError(f"{KERNEL_CLUSTER} cluster size: CUDA error {err}")
    return out.value


def resident_plan(lq: int, lk: int, dh: int):
    """(shared memory bytes, threads, blocks an SM) of a resident K2 block
    at Lq x Lk and head width dh, as the built library reports them."""
    fn = build.load(KERNEL_RESIDENT).deepsc_attention_bwd_resident_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(lq, lk, dh, out)
    if err != 0:
        raise ValueError(f"{KERNEL_RESIDENT} does not take {lq} x {lk} at "
                         f"head width {dh}: CUDA error {err}")
    return tuple(out)


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
    if k.shape[0] != n or k.shape[2] != hd or heads < 1 or hd % heads:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} with {heads} heads")
    if tuple(bias.shape) != (n, lq, lk):
        raise ValueError(f"bias {tuple(bias.shape)} is not {(n, lq, lk)}")
    if not takes_head_dim(hd // heads):
        raise ValueError(f"{heads} heads of width {hd // heads}: the kernels "
                         f"take head widths from 1")
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


def smem_bytes(kernel, lq: int, lk: int, heads: int, dh: int) -> int:
    """Shared memory one block of the tuned bf16 `kernel` ("attention_fwd"
    or "attention_bwd") needs for Lq x Lk at `heads` heads of `dh` (past
    TILE of either, the long-length kernels'), as its built library
    computes it (the library is built on first use)."""
    return _bind(kernel)[1](lq, lk, heads, dh)


def _tuned(kernel, q, k, heads):
    """(launch function, whether it is the long-length backward entry) of
    the tuned bf16 kernel for q and k, after checking its shared memory."""
    n, lq, hd = q.shape
    lk, dh = k.shape[1], hd // heads
    limit = torch.cuda.get_device_properties(q.device) \
        .shared_memory_per_block_optin
    long_bwd = kernel == KERNEL_BWD and is_long(lq, lk)
    smem = smem_bytes(kernel, lq, lk, heads, dh)
    if smem > limit:
        raise ValueError(f"{kernel} kernel needs {smem} bytes of shared "
                         f"memory per block; the device allows {limit}")
    return _bind(kernel, long_bwd)[0], long_bwd


def attention_fwd(q, k, v, bias, heads: int, scale: float):
    """K1's wrapper: softmax(q k^T / scale + bias) v per head."""
    if not _on_cuda(q):
        return attention_fwd_reference(q, k, v, bias, heads, scale)
    _check(q, k, v, bias, heads)
    n, lq, hd = q.shape
    lk, dh = k.shape[1], hd // heads
    wide = is_wide(heads, dh)
    tiled = uses_tiled(q.dtype, heads, dh)
    narrow = uses_narrow(q.dtype, heads, dh)
    pointers = []
    if narrow:
        fn = _bind_narrow(KERNEL)
    elif is_chunked_mma(q.dtype, heads, dh):
        fn = _bind_tensor_core(KERNEL_CHUNKED, KERNEL)
    elif is_wide_mma(q.dtype, heads, dh):
        fn = _bind_tensor_core(KERNEL_WIDE_MMA, KERNEL)
    elif tiled:
        fn = _bind_tiled()[0]
        # the logits of rows of keys too long for a block's shared memory
        floats = tiled_scratch_floats(n, lq, lk, heads, dh)
        pointers = [torch.empty(floats, dtype=torch.float32, device=q.device)
                    if floats else None]
    else:
        fn = _tuned(KERNEL, q, k, heads)[0]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
             out.data_ptr(),
             *(None if t is None else t.data_ptr() for t in pointers),
             n, lq, lk, heads, dh, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error "
                           f"{err}")
    global launches, wide_launches, tiled_launches, narrow_launches
    launches += 1
    wide_launches += wide
    tiled_launches += tiled
    narrow_launches += narrow
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
    n, lq, hd = q.shape
    lk, dh = k.shape[1], hd // heads
    wide = is_wide(heads, dh)
    library = (KERNEL_WIDE_MMA if is_wide_mma(q.dtype, heads, dh)
               else KERNEL_CHUNKED
               if is_chunked_mma(q.dtype, heads, dh) else None)
    mma = library is not None
    resident = uses_resident(q.dtype, lq, lk, heads, dh)
    cluster = uses_cluster(q.dtype, lq, lk, heads, dh)
    tiled = uses_tiled(q.dtype, heads, dh)
    narrow = uses_narrow(q.dtype, heads, dh)
    if mma:
        fn, scratch = _bind_tensor_core(library, KERNEL_BWD), is_long(lq, lk)
    elif resident:
        fn, scratch = _bind_resident(), False
    elif cluster:
        fn, scratch = _bind_cluster(), False
    elif tiled:
        fn, scratch = _bind_tiled_bwd(), False
    elif narrow:
        fn, scratch = _bind_narrow(KERNEL_BWD), False
    else:
        fn, scratch = _tuned(KERNEL_BWD, q, k, heads)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dbias = torch.empty_like(bias) if need_dbias else None
    # the long-length kernels' softmax statistics (m, l, rowsum(dp p), pad)
    # per (row, head, query), written by the dq kernel, read by the dk/dv
    # one (the tensor-core wide and chunked kernels need them only past
    # TILE queries or keys)
    stats = torch.empty((n, heads, lq, 4), dtype=torch.float32,
                        device=q.device) if scratch else None
    pointers = [stats] if scratch else []
    if resident or cluster:
        # each head's f32 ds, summed over the heads for dbias
        pointers = [torch.empty((n, heads, lq, lk), dtype=torch.float32,
                                device=q.device) if need_dbias else None]
    elif mma:
        # the scratch may be null here, and each head's f32 ds goes to a
        # second one, summed over the heads for dbias
        ds = torch.empty((n, heads, lq, lk), dtype=torch.float32,
                         device=q.device) if need_dbias else None
        pointers = [stats, ds]
    elif tiled:
        # each head's p and dss (and ds, summed over the heads for dbias)
        pointers = [torch.empty(tiled_bwd_scratch_floats(
            n, lq, lk, heads, need_dbias), dtype=torch.float32,
            device=q.device)]
    elif narrow:
        # the row statistics past TILE, and each head's ds for dbias
        floats = narrow_bwd_scratch_floats(n, lq, lk, heads, need_dbias)
        pointers = [torch.empty(floats, dtype=torch.float32, device=q.device)
                    if floats else None]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
             g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             None if dbias is None else dbias.data_ptr(),
             *(None if t is None else t.data_ptr() for t in pointers),
             n, lq, lk, heads, dh, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: CUDA "
                           f"error {err}")
    global bwd_launches, wide_bwd_launches, cluster_bwd_launches
    global tiled_bwd_launches, narrow_bwd_launches
    bwd_launches += 1
    wide_bwd_launches += wide
    cluster_bwd_launches += cluster
    tiled_bwd_launches += tiled
    narrow_bwd_launches += narrow
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
