"""The port's vocab cross-entropy against the JAX package on the CPU at
f32: the plain versions of the CE kernels K3/K4 against the TPU kernels
(`pallas_softmax_xent` under the Pallas interpreter) at the padding cases of
tests/test_pallas_ce.py, the masked `fused_ce_loss` with label smoothing and
quirk Q2's extra ids, tied and untied, and `loss_function` on materialized
logits. The CUDA kernels themselves are held against the plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.ops.fused_ce import fused_ce_loss as jax_fused_ce_loss
from deepsc_gan_tpu.ops.losses import loss_function as jax_loss_function
from deepsc_gan_tpu.ops.pallas.ce import (
    _pallas_ce_fwd,
    pallas_softmax_xent,
    set_ce_kernel_mode,
)
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
from deepsc_gan_tpu_torch.ops.fused_ce import fused_ce_loss
from deepsc_gan_tpu_torch.ops.losses import loss_function

TOL = 1e-5


@pytest.fixture
def interpret():
    set_ce_kernel_mode("interpret")
    try:
        yield
    finally:
        set_ce_kernel_mode("auto")


def _case(n, d, v, seed=0):
    """h (N, D), W (D, V) in the JAX layout, b (V,), labels (N,),
    per-row weights (N,): numpy f32 / int32."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    W = (0.3 * rng.standard_normal((d, v))).astype(np.float32)
    b = (0.1 * rng.standard_normal(v)).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    weights = rng.random(n).astype(np.float32)
    return h, W, b, labels, weights


def _leaf(x):
    return torch.tensor(np.asarray(x), requires_grad=True)


@pytest.mark.parametrize("n,d,v,tn,tv", [
    (16, 8, 40, 8, 16),     # padding on both axes
    (24, 16, 64, 8, 32),    # exact tiles
    (10, 8, 50, 16, 32),    # n < tile
    (24, 200, 64, 8, 32),   # the widened decoder's width (the wide K3/K4)
    (16, 264, 64, 8, 32),   # past 256, off the 16-column k-step
])
def test_ce_plain_versions_match_jax_kernels(interpret, n, d, v, tn, tv):
    """ce, and dh, dW, db of sum(ce * weights) through jax.grad, against
    the plain forward and backward (through the autograd Function, W in the
    port's (V, D) layout)."""
    h, W, b, labels, weights = _case(n, d, v)

    def loss(h, W, b):
        return jnp.sum(pallas_softmax_xent(h, W, b, jnp.asarray(labels), tn,
                                           tv) * weights)

    want_ce = np.asarray(pallas_softmax_xent(
        jnp.asarray(h), jnp.asarray(W), jnp.asarray(b), jnp.asarray(labels),
        tn, tv))
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(h), jnp.asarray(W),
                                             jnp.asarray(b))

    ht, Wt, bt = _leaf(h), _leaf(W.T.copy()), _leaf(b)
    lab = torch.from_numpy(labels)
    ce.reset_launches()
    got_ce = ce.softmax_xent(ht, Wt, bt, lab)
    np.testing.assert_allclose(got_ce.detach().numpy(), want_ce, atol=TOL)
    (got_ce * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want[0]), atol=TOL)
    np.testing.assert_allclose(Wt.grad.numpy().T, np.asarray(want[1]),
                               atol=TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want[2]), atol=TOL)
    # the wrappers ran the plain versions on these CPU tensors: no launch
    assert ce.fwd_launches == 0 and ce.bwd_launches == 0


def test_ce_reference_returns_lse_and_zero_cotangent_rows():
    """lse is the row's logsumexp; a zero cotangent gives zero dh rows and
    no contribution to dW and db (the TPU kernels' padded rows)."""
    h, W, b, labels, _ = _case(12, 8, 37, seed=1)
    ht, Wt, bt = (torch.from_numpy(a) for a in (h, W.T.copy(), b))
    lab = torch.from_numpy(labels)
    cel, lse = ce.ce_fwd_reference(ht, Wt, bt, lab)
    logits = ht @ Wt.T + bt
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))
    torch.testing.assert_close(cel, lse - logits[torch.arange(12), lab.long()])
    g = torch.ones(12)
    g[8:] = 0.0
    dh, dW, db = ce.ce_bwd_reference(ht, Wt, bt, lab, lse, g)
    assert torch.count_nonzero(dh[8:]) == 0
    dh8, dW8, db8 = ce.ce_bwd_reference(ht[:8], Wt, bt, lab[:8], lse[:8],
                                        g[:8])
    torch.testing.assert_close(dh[:8], dh8)
    torch.testing.assert_close(dW, dW8)
    torch.testing.assert_close(db, db8)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("smoothing,extra", [(0.0, None), (0.1, None),
                                             (0.0, (4, 5)), (0.1, (4, 5))])
def test_fused_ce_loss_matches_jax(interpret, tie, smoothing, extra):
    """The masked loss and its grads w.r.t. hidden, the vocab table E
    (V, D) and b. The JAX package projects with W = E.T (D, V), the port
    with E itself. Tied, the hidden states also look E up (as a tied
    decoder's embedding does), so E's grad sums the lookup's and the CE's."""
    bsz, length, d, v = 3, 7, 8, 40
    rng = np.random.default_rng(2 + tie)
    hidden = rng.standard_normal((bsz, length, d)).astype(np.float32)
    E = (0.3 * rng.standard_normal((v, d))).astype(np.float32)
    b = (0.1 * rng.standard_normal(v)).astype(np.float32)
    real = rng.integers(0, 8, (bsz, length)).astype(np.int32)
    real[:, -2:] = 0  # padding
    tok = rng.integers(0, v, (bsz, length))

    def jloss(hidden, E, b):
        h = hidden + E[tok] if tie else hidden
        return jax_fused_ce_loss(h, E.T, b, jnp.asarray(real),
                                 extra_masked_ids=extra,
                                 label_smoothing=smoothing)

    want_v, want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(hidden), jnp.asarray(E), jnp.asarray(b))
    ht, Et, bt = _leaf(hidden), _leaf(E), _leaf(b)
    h = ht + Et[torch.from_numpy(tok)] if tie else ht
    got = fused_ce_loss(h, Et, bt, torch.from_numpy(real).long(),
                        extra_masked_ids=extra, label_smoothing=smoothing)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want_v), rtol=TOL)
    for t, w in zip((ht, Et, bt), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=TOL)


@pytest.mark.parametrize("smoothing,extra", [(0.0, None), (0.1, (4, 5))])
def test_loss_function_matches_jax(smoothing, extra):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 40)).astype(np.float32)
    real = rng.integers(0, 8, (3, 7)).astype(np.int32)
    want = jax_loss_function(jnp.asarray(real), jnp.asarray(logits),
                             extra_masked_ids=extra,
                             label_smoothing=smoothing)
    got = loss_function(torch.from_numpy(real), torch.from_numpy(logits),
                        extra_masked_ids=extra, label_smoothing=smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)


@pytest.mark.parametrize("n,v,sms", [(1984, 22234, 132), (1984, 22234, 1),
                                     (16, 40, 132), (7, 64, 4),
                                     (100000, 22234, 132), (64, 129, 132)])
def test_vocab_splits_leave_no_split_empty(n, v, sms):
    """The C entry points refuse a split that owns no vocab tile: the CE
    kernels' splits (`ce.vocab_splits`, here at the tilings the kernels
    report: 64-row h tiles, vocab tiles of 64 or 128 rows, one to three
    blocks per SM), whose blocks also fit in one wave; K6 takes its splits
    from the same function at the tiles its library reports."""
    cases = []
    for vocab_rows, blocks in ((64, 1), (64, 2), (128, 2), (64, 3)):
        splits = ce.vocab_splits(n, v, sms, 64, vocab_rows, blocks)
        assert splits == 1 or -(-n // 64) * splits <= blocks * sms
        cases.append((splits, vocab_rows))
    for splits, vocab_rows in cases:
        tiles = -(-v // vocab_rows)
        per = -(-tiles // splits)
        assert 1 <= splits <= tiles and (splits - 1) * per < tiles


def test_vocab_splits_fill_one_wave_at_the_training_shape():
    """At the training path's shape on 132 SMs the 31 row tiles take 8
    forward splits (vocab tiles of 128, two blocks per SM: the bf16 K3) and
    12 dh splits (tiles of 64, three blocks per SM: the bf16 K4), one wave
    each."""
    assert ce.vocab_splits(1984, 22234, 132, 64, 128, 2) == 8
    assert ce.vocab_splits(1984, 22234, 132, 64, 64, 3) == 12


def _ok_args(dtype=torch.bfloat16, n=4, d=128, v=100):
    return (torch.zeros((n, d), dtype=dtype), torch.zeros((v, d), dtype=dtype),
            torch.zeros(v), torch.zeros(n, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["dtype", "mixed", "width", "wide", "bias",
                                 "labels", "rows", "contiguous", "aligned",
                                 "layout", "bf16_width"])
def test_ce_wrapper_rejects_what_the_kernels_do_not_take(bad):
    """The checks the wrappers make before a launch (they run on any
    device; here on CPU tensors)."""
    ce._check(*_ok_args())
    h, W, b, labels = _ok_args()
    rows = ()
    if bad == "dtype":
        h, W = h.half(), W.half()
    elif bad == "mixed":
        W = W.float()
    elif bad == "width":  # no columns at all
        h, W, b, labels = _ok_args(d=0)
    elif bad == "wide":  # h wider than the table
        h = _ok_args(d=264)[0]
    elif bad == "bias":
        b = torch.zeros(99)
    elif bad == "labels":
        labels = labels.long()
    elif bad == "rows":
        rows = (torch.zeros(3),)
    elif bad == "contiguous":
        W = torch.zeros((128, 100), dtype=W.dtype).t()
    elif bad == "aligned":
        h = torch.zeros(h.numel() + 1, dtype=h.dtype)[1:].view(h.shape)
    elif bad == "layout":
        W = torch.zeros((128, 100), dtype=W.dtype)
    elif bad == "bf16_width":
        # a multiple of 8 the tuned f32 kernels take, but not of the 16
        # columns of a bf16 wgmma k-step: the wide kernels take it; a bf16
        # h against an f32 table of that width is still refused
        ce._check(*_ok_args(torch.float32, d=24))
        ce._check(*_ok_args(d=24))
        assert ce.is_wide(torch.bfloat16, 24)
        assert not ce.is_wide(torch.float32, 24)
        h, W, b, labels = _ok_args(d=24)
        W = W.float()
    with pytest.raises((TypeError, ValueError)):
        ce._check(h, W, b, labels, *rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [12, 24, 200, 264, 512])
def test_ce_wrapper_takes_any_width(dtype, d):
    """Widths off the tuned kernels' step or past 256 pass the checks and
    go to the wide kernels on the card; the training width stays tuned."""
    ce._check(*_ok_args(dtype, d=d))
    assert ce.is_wide(dtype, d) == (d % ce.D_STEP[dtype] != 0 or d > 256)
    assert not ce.is_wide(dtype, 128)


def test_ce_wrappers_never_fall_back_off_the_cpu():
    h = torch.zeros((4, 8), device="meta")
    W = torch.zeros((40, 8), device="meta")
    b = torch.zeros(40, device="meta")
    labels = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ce.ce_fwd(h, W, b, labels)
    with pytest.raises(ValueError, match="CUDA"):
        ce.ce_bwd(h, W, b, labels, torch.zeros(4, device="meta"),
                  torch.zeros(4, device="meta"))


@pytest.mark.parametrize("d,dp", [(1, 8), (8, 8), (12, 16), (200, 200),
                                  (257, 264), (4097, 4104)])
def test_wide_bwd_pads_to_the_tma_row(d, dp):
    """The bf16 wide K4 reads h and W at d rounded up to 8 columns (rows of
    16 bytes for the TMA)."""
    assert ce.padded_width(d) == dp


@pytest.mark.parametrize("dp,plan", [
    (8, (1, 1, 1, 1, 4, 43520)),
    (200, (4, 1, 4, 2, 4, 117248)),
    (512, (8, 1, 8, 4, 4, 215552)),
    (640, (10, 1, 10, 5, 3, 223360)),
    (1000, (16, 2, 8, 4, 4, 215552)),
    (2048, (32, 4, 8, 4, 4, 215552)),
    (4104, (65, 7, 10, 5, 3, 223360)),
    (5120, (80, 8, 10, 5, 3, 223360))])
def test_wide_bwd_plan(dp, plan):
    """How csrc/ce_wide_bwd.cu cuts a width (the card test holds this
    mirror to the library's own): at most 10 slabs of 64 columns a block,
    blocks in clusters past 640 columns, shared memory within the card's
    227 KB a block and at least two stages."""
    got = ce.wide_bwd_plan(dp)
    assert tuple(got) == plan
    assert got.smem <= 232448 and got.stages >= 2
    assert got.cluster * got.block_slabs >= got.slabs
    assert (got.cluster - 1) * got.block_slabs < got.slabs


@pytest.mark.parametrize("dp", [0, 12, 5128, 8192])
def test_wide_bwd_plan_refuses(dp):
    """No plan off the TMA's 8-column step or past 8 blocks of 640."""
    assert ce.wide_bwd_plan(dp) is None


@pytest.mark.parametrize("dp,plan", [
    (8, (1, 3, 74752)), (200, (4, 3, 74752)), (264, (5, 3, 74752)),
    (512, (8, 3, 74752)), (640, (10, 3, 74752)), (5128, (81, 3, 74752))])
def test_wide_fwd_plan(dp, plan):
    """How csrc/ce_wide_fwd.cu cuts a width (the card test holds this
    mirror to the library's own): k-chunks of 64 columns, a ring of 3
    stages of a chunk of h's 64 rows and W's 128 (24 KB), the same shared
    memory at every width, within a third of the card's 228 KB an SM
    (three blocks an SM)."""
    got = ce.wide_fwd_plan(dp)
    assert tuple(got) == plan
    assert got.chunks * ce.SLAB >= dp > (got.chunks - 1) * ce.SLAB
    assert 3 * (got.smem + 1024) <= 233472


@pytest.mark.parametrize("dp", [0, 12, 201])
def test_wide_fwd_plan_refuses(dp):
    """No plan off the TMA's 8-column step: the wrapper pads such widths
    (`padded_width`) before the launch."""
    assert ce.wide_fwd_plan(dp) is None
    assert ce.wide_fwd_plan(ce.padded_width(dp or 1)) is not None


@pytest.mark.parametrize("dtype,d,tensor_cores", [
    (torch.bfloat16, 200, True), (torch.bfloat16, 640, True),
    (torch.bfloat16, 12, True), (torch.bfloat16, 5128, True),
    (torch.bfloat16, 128, False), (torch.bfloat16, 256, False),
    (torch.float32, 200, False), (torch.float32, 640, False),
    (torch.float32, 12, False), (torch.float32, 128, False),
    (torch.float32, 264, False), (torch.float32, 1, False)])
def test_wide_fwd_routing(dtype, d, tensor_cores):
    """K3 in bf16 at every width the tuned kernel does not take runs the
    tensor-core wide kernel (csrc/ce_wide_fwd.cu), past 5,120 columns too,
    and the tuned widths the tuned kernel; every f32 K3, at the tuned
    widths too, runs the tiled kernel (csrc/ce_fwd_tiled.cu: exact f32
    products on the CUDA cores), and no bf16 one."""
    assert ce.uses_tensor_core_fwd(dtype, d) == tensor_cores
    assert not tensor_cores or ce.is_wide(dtype, d)
    assert ce.uses_tiled_fwd(dtype, d) == (dtype == torch.float32)


def test_wide_bwd_routing():
    """bf16 off the tuned widths up to 5,120 runs the tensor-core wide K4;
    f32 and wider bf16 the tiled kernels; tuned widths neither."""
    assert ce.uses_tensor_core_bwd(torch.bfloat16, 640)
    assert ce.uses_tensor_core_bwd(torch.bfloat16, 12)
    assert ce.uses_tensor_core_bwd(torch.bfloat16, 5120)
    assert not ce.uses_tensor_core_bwd(torch.bfloat16, 5121)
    assert not ce.uses_tensor_core_bwd(torch.bfloat16, 128)
    assert not ce.uses_tensor_core_bwd(torch.float32, 640)


@pytest.mark.parametrize("dtype,d,tiled", [
    (torch.float32, 640, True), (torch.float32, 512, True),
    (torch.float32, 264, True), (torch.float32, 12, True),
    (torch.float32, 1, True), (torch.float32, 257, True),
    (torch.float32, 5128, True), (torch.float32, 128, True),
    (torch.float32, 200, True), (torch.float32, 256, True),
    (torch.float32, 8, True), (torch.float32, 136, True),
    (torch.bfloat16, 5121, True), (torch.bfloat16, 5128, True),
    (torch.bfloat16, 5120, False), (torch.bfloat16, 640, False),
    (torch.bfloat16, 200, False), (torch.bfloat16, 128, False)])
def test_tiled_bwd_routing(dtype, d, tiled):
    """K4 runs the tiled kernels (csrc/ce_bwd_tiled.cu) at every f32 width,
    the tuned widths (the main model's D = 128, the widened decoder's 200)
    too, and in bf16 past the tensor-core wide kernels' 5,120 columns;
    every other bf16 width off the tuned ones runs the tensor-core wide
    kernels, the tuned bf16 widths the tuned kernel. A call counts as wide
    off the tuned widths alone."""
    assert ce.uses_tiled_bwd(dtype, d) == tiled
    assert not (tiled and ce.uses_tensor_core_bwd(dtype, d))
    assert not tiled or dtype == torch.float32 or ce.is_wide(dtype, d)


@pytest.mark.parametrize("n,d,v,sms,blocks", [
    (1984, 640, 22234, 132, 2), (1984, 512, 22234, 132, 1),
    (1984, 264, 22234, 132, 3), (16, 12, 40, 132, 2), (1, 3, 1, 132, 2),
    (100000, 640, 22234, 132, 2), (300, 520, 3000, 4, 2),
    (64, 5128, 129, 132, 2)])
def test_tiled_splits_own_vocab_tiles(n, d, v, sms, blocks):
    """The tiled K4's dh product cuts the vocab into splits of whole
    128-row tiles, none empty (the library refuses an empty one), covering
    the workspace's vocab in order, their blocks within one wave; the
    workspace holds N and V rounded up to 128."""
    splits = ce.tiled_splits(n, d, v, sms, blocks)
    np_, vp = ce.tiled_workspace(n, v)
    assert np_ % 128 == 0 and vp % 128 == 0
    assert n <= np_ < n + 128 and v <= vp < v + 128
    assert splits == 1 or -(-n // 128) * -(-d // 128) * splits \
        <= blocks * sms
    ranges = ce.tiled_split_ranges(v, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 \
        and ranges[-1][1] == vp
    assert all(lo < hi and lo % 128 == 0 for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    tiles = vp // 128
    per = -(-tiles // splits)
    assert (splits - 1) * per < tiles


def _fma(a, b, c):
    """f32 fmaf(a, b, c), emulated: the exact product and sum in f64 (a
    product of two f32 values is exact there), rounded once to f32."""
    return (a.double() * b.double() + c.double()).float()


def _tiled_ce_bwd(h, W, b, labels, lse, g, splits, dh_only, dw_splits=1):
    """The tiled K4's arithmetic in its order (csrc/ce_bwd_tiled.cu) on
    f32 CPU tensors: each logit a sum over d in order 0..D-1 by fmaf, then
    P = exp((logit + b) - lse) g, less g at the label; dh a sum over each
    vocab split's rows in order by fmaf, the splits' partials added in
    split order (`ce.tiled_split_ranges`); dW a sum over each row split's
    rows n in order by fmaf and db = sum_n P over them in order, the row
    splits' partials added in split order (`ce.tiled_split_ranges` of N)."""
    n, d = h.shape
    v = W.shape[0]
    acc = torch.zeros((n, v))
    for k in range(d):
        acc = _fma(h[:, k, None], W[None, :, k], acc)
    p = torch.exp((acc + b) - lse[:, None]) * g[:, None]
    rows = torch.arange(n)
    p[rows, labels.long()] -= g
    parts = []
    for lo, hi in ce.tiled_split_ranges(v, splits):
        part = torch.zeros((n, d))
        for j in range(lo, min(hi, v)):  # rows past V add exact zeros
            part = _fma(p[:, j, None], W[None, j, :], part)
        parts.append(part)
    dh = parts[0]
    if splits > 1:
        dh = torch.zeros((n, d))
        for part in parts:
            dh = dh + part
    if dh_only:
        return dh, None, None
    parts = []
    for lo, hi in ce.tiled_split_ranges(n, dw_splits):
        dW, db = torch.zeros((v, d)), torch.zeros(v)
        for i in range(lo, min(hi, n)):  # rows past N add exact zeros
            dW = _fma(p[i, :, None], h[None, i, :], dW)
            db = db + p[i]
        parts.append((dW, db))
    if dw_splits == 1:
        return (dh,) + parts[0]
    dW, db = torch.zeros((v, d)), torch.zeros(v)
    for pw, pb in parts:
        dW, db = dW + pw, db + pb
    return dh, dW, db


_JAX_CE_GRADS = {}


def _jax_ce_grads(n, d, v, tn=8, tv=32):
    """dh, dW (port layout) and db of sum(ce * weights) through the TPU
    kernels under the Pallas interpreter (tiles of tn rows and tv vocab
    entries), once per shape."""
    if (n, d, v) not in _JAX_CE_GRADS:
        h, W, b, labels, weights = _case(n, d, v, seed=3)
        set_ce_kernel_mode("interpret")
        try:
            grads = jax.grad(lambda h, W, b: jnp.sum(pallas_softmax_xent(
                h, W, b, jnp.asarray(labels), tn, tv) * weights),
                argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (h, W, b)))
        finally:
            set_ce_kernel_mode("auto")
        _JAX_CE_GRADS[(n, d, v)] = (np.asarray(grads[0]),
                                    np.asarray(grads[1]).T,
                                    np.asarray(grads[2]))
    return _JAX_CE_GRADS[(n, d, v)]


@pytest.mark.parametrize("d", [8, 128, 200, 264, 520])
@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("dh_only", [False, True])
def test_tiled_bwd_emulation_matches_plain_version(d, splits, dh_only):
    """The tiled K4's order of sums and roundings (`_tiled_ce_bwd`) at
    D = 8 (less than one chunk of 16), 128 (the main model's), 200 (the
    widened decoder's), 264 and 520 (past 256, off 8 and 16 columns at
    264), V = 300 (three vocab tiles of 128, the last ragged), one or two
    vocab splits of the dh product, in both modes: against the plain
    version and against the TPU
    kernels' gradients (under the Pallas interpreter) within 1e-5 of each
    gradient's largest value, as chip_smoke.py holds the kernel; the
    dh-only mode's dh is the full mode's."""
    n, v = 40, 300
    h, W, b, labels, weights = _case(n, d, v, seed=3)
    ht, Wt, bt = (torch.from_numpy(a) for a in (h, W.T.copy(), b))
    lab = torch.from_numpy(labels)
    lse = ce.ce_fwd_reference(ht, Wt, bt, lab)[1]
    g = torch.from_numpy(weights)
    got = _tiled_ce_bwd(ht, Wt, bt, lab, lse, g, splits, dh_only)
    want = ce.ce_bwd_reference(ht, Wt, bt, lab, lse, g, dh_only=dh_only)
    jax_grads = _jax_ce_grads(n, d, v)
    for name, a, r, j in zip(("dh", "dW", "db"), got, want, jax_grads):
        if r is None:
            assert a is None, name
            continue
        scale = r.abs().max().item()
        assert (a - r).abs().max().item() <= 1e-5 * scale, name
        assert np.abs(a.numpy() - j).max() <= 1e-5 * scale, name
    if dh_only:
        full = _tiled_ce_bwd(ht, Wt, bt, lab, lse, g, splits, False)
        assert torch.equal(got[0], full[0])


def _tiled_ce_fwd(h, W, b, labels, splits):
    """The tiled K3's arithmetic in its order (csrc/ce_fwd_tiled.cu) on f32
    CPU tensors: each logit a sum over d in order 0..D-1 by fmaf, plus the
    bias; per split (`ce.tiled_split_ranges`) and vocab tile of 128 in
    order, each of the 16 threads of a row takes the max of its 8 columns
    (4 tx + j and 64 + 4 tx + j, j < 4) and the half-warp the max of
    theirs; each thread sums the exponentials of its columns less the new
    max in column order, the half-warp adds the 16 sums by xor shuffles
    (1, 2, 4, 8), and the row's running sum is rescaled to the new max;
    then the splits merged in order: lse = max + log(sum of the rescaled
    sums), ce = lse - the gold logit. -> (ce, lse)."""
    n, d = h.shape
    v = W.shape[0]
    acc = torch.zeros((n, v))
    for k in range(d):
        acc = _fma(h[:, k, None], W[None, :, k], acc)
    x = acc + b
    neg = torch.full((n,), -1e30)
    cols = [[4 * tx + j for j in range(4)] + [64 + 4 * tx + j
                                              for j in range(4)]
            for tx in range(16)]
    parts = []
    for lo, hi in ce.tiled_split_ranges(v, splits):
        m, s = neg.clone(), torch.zeros(n)
        for c0 in range(lo, hi, 128):
            own = [[c0 + c for c in cs if c0 + c < v] for cs in cols]
            cm = torch.stack([x[:, o].max(dim=1).values if o else neg
                              for o in own])
            mn = torch.maximum(m, cm.max(dim=0).values)
            se = []
            for o in own:
                acc_se = torch.zeros(n)
                for c in o:
                    acc_se = acc_se + torch.exp(x[:, c] - mn)
                se.append(acc_se)
            for step in (1, 2, 4, 8):
                se = [se[t] + se[t ^ step] for t in range(16)]
            s = s * torch.exp(m - mn) + se[0]
            m = mn
        inside = (labels >= lo) & (labels < hi)
        gold = torch.where(inside, x[torch.arange(n),
                                     labels.long().clamp(0, v - 1)],
                           torch.zeros(n))
        parts.append((m, s, gold))
    mm = torch.stack([p[0] for p in parts]).max(dim=0).values
    ss, gg = torch.zeros(n), torch.zeros(n)
    for pm, ps, pg in parts:
        ss = ss + ps * torch.exp(pm - mm)
        gg = gg + pg
    lse = mm + torch.log(ss)
    return lse - gg, lse


@pytest.mark.parametrize("d", [8, 128, 200, 264])
@pytest.mark.parametrize("splits", [1, 3])
def test_tiled_fwd_emulation_matches_plain_version(d, splits):
    """The tiled K3's order of sums and roundings (`_tiled_ce_fwd`) at
    D = 8, 128 (the main model's), 200 (the widened decoder's) and 264,
    N = 130 (a ragged second row tile), V = 700 (six vocab tiles of 128, the
    last ragged), one vocab split or three: ce and lse within 1e-6 of the
    largest of the plain version's (values up to 30 here, whose f32 step
    is 1.9e-6) of the plain version and of the TPU kernel (under the
    Pallas interpreter)."""
    n, v = 130, 700
    h, W, b, labels, _ = _case(n, d, v, seed=4)
    ht, Wt, bt = (torch.from_numpy(a) for a in (h, W.T.copy(), b))
    lab = torch.from_numpy(labels)
    got = _tiled_ce_fwd(ht, Wt, bt, lab, splits)
    want = ce.ce_fwd_reference(ht, Wt, bt, lab)
    jax_ce, jax_lse = _pallas_ce_fwd(jnp.asarray(h), jnp.asarray(W),
                                     jnp.asarray(b), jnp.asarray(labels), 8,
                                     32, True)
    for name, a, r, j in zip(("ce", "lse"), got, want, (jax_ce, jax_lse)):
        tol = 1e-6 * r.abs().max().item()
        assert (a - r).abs().max().item() <= tol, name
        assert np.abs(a.numpy() - np.asarray(j)).max() <= tol, name


@pytest.mark.parametrize("n,d,v,sms,blocks,want", [
    (1984, 128, 22234, 132, 2, 3), (1984, 200, 22234, 132, 2, 1),
    (1984, 136, 22234, 132, 2, 1), (1984, 264, 22234, 132, 2, 1),
    (1984, 512, 22234, 132, 2, 1), (1984, 640, 22234, 132, 2, 1),
    (1, 3, 1, 132, 2, 1), (300, 520, 3000, 132, 2, 2),
    (129, 8, 100, 132, 2, 2), (100000, 128, 22234, 132, 2, 3),
    (128, 128, 22234, 132, 2, 1)])
def test_tiled_dw_row_splits(n, d, v, sms, blocks, want):
    """The tiled K4's dW product takes row splits only where its blocks
    leave a wave of the card's block slots part idle: three at the main
    model's D = 128 (174 vocab tiles for 264 slots, at any N), as many as
    fill the wave on small vocabularies, none at D = 136 and past (two
    column tiles: the blocks fill a wave) nor where N has one row tile;
    each split owns whole row tiles, none empty, covering the workspace's
    rows in order."""
    splits = ce.tiled_dw_splits(n, d, v, sms, blocks)
    assert splits == want
    ranges = ce.tiled_split_ranges(n, splits)
    np_ = ce.tiled_workspace(n, v)[0]
    assert len(ranges) == splits and ranges[0][0] == 0 \
        and ranges[-1][1] == np_
    assert all(lo < hi and lo % 128 == 0 for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("dw_splits", [1, 2, 3])
def test_tiled_bwd_row_split_emulation_matches_plain_version(dw_splits):
    """The tiled K4's order of sums with its dW product cut into row
    splits (`_tiled_ce_bwd`, N = 300: three row tiles of 128, the last
    ragged; D = 128, V = 300, two vocab splits of dh): dh, dW and db within
    1e-5 of each gradient's largest value of the plain version's and of the
    TPU kernels' (under the Pallas interpreter); dh does not depend on the
    row splits."""
    n, d, v = 300, 128, 300
    h, W, b, labels, weights = _case(n, d, v, seed=3)
    ht, Wt, bt = (torch.from_numpy(a) for a in (h, W.T.copy(), b))
    lab = torch.from_numpy(labels)
    lse = ce.ce_fwd_reference(ht, Wt, bt, lab)[1]
    g = torch.from_numpy(weights)
    got = _tiled_ce_bwd(ht, Wt, bt, lab, lse, g, 2, False, dw_splits)
    want = ce.ce_bwd_reference(ht, Wt, bt, lab, lse, g)
    jax_grads = _jax_ce_grads(n, d, v, 64, 128)
    for name, a, r, j in zip(("dh", "dW", "db"), got, want, jax_grads):
        scale = r.abs().max().item()
        assert (a - r).abs().max().item() <= 1e-5 * scale, name
        assert np.abs(a.numpy() - j).max() <= 1e-5 * scale, name
    one = _tiled_ce_bwd(ht, Wt, bt, lab, lse, g, 2, True)
    assert torch.equal(got[0], one[0])


def _k4_f64(h, W, b, labels, lse, g, softmax_only=False):
    """K4's function on bf16 operands in f64: P from f64 logits less lse,
    rounded to bf16 through f32 (-> Pc too); the products and db in f64."""
    hh, ww = h.double(), W.double()
    p = torch.exp(hh @ ww.t() + b.double() - lse.double()[:, None]) \
        * g.double()[:, None]
    if not softmax_only:
        p[torch.arange(h.shape[0]), labels.long()] -= g.double()
    pc = p.float().to(torch.bfloat16).double()
    return (pc @ ww, pc.t() @ hh, p.sum(0)), pc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_k4_plain_version_rounds_p_from_f64(seed):
    """The bf16 K4 plain version rounds P to bf16 from its f64 value: its
    dh and dW are the products of that Pc, bitwise, and its softmax part
    sits within f32 product rounding (5e-6 of the part) of an f64
    evaluation. P formed in f32, as the version before formed it, rounds
    some elements to the other bf16 neighbour (tens here; at chip_smoke's
    shape on the card that put the softmax part 2.5e-3 off the f64
    evaluation at D = 640, past the 2e-3 gate, where the kernel read 9.4e-4:
    scripts/ce_softmax_gate.py)."""
    gen = torch.Generator().manual_seed(seed)
    n, d, v = 256, 640, 2048
    h = torch.randn((n, d), generator=gen).to(torch.bfloat16)
    W = (0.1 * torch.randn((v, d), generator=gen)).to(torch.bfloat16)
    b = 0.1 * torch.randn(v, generator=gen)
    labels = torch.randint(0, v, (n,), generator=gen)
    g = torch.rand(n, generator=gen)
    lse = ce.ce_fwd_reference(h, W, b, labels)[1]
    args = (h, W, b, labels, lse, g)
    part, _ = _k4_f64(*args, softmax_only=True)
    exact, pc = _k4_f64(*args)
    got = ce.ce_bwd_reference(*args)
    pc = pc.float()
    assert torch.equal(got[0], pc @ W.float())
    assert torch.equal(got[1], pc.t() @ h.float())
    assert max(float((x.double() - r).abs().max() / s.abs().max())
               for x, r, s in zip(got, exact, part)) <= 5e-6
    hf, wf = h.float(), W.float()
    p32 = torch.exp(hf @ wf.t() + b - lse[:, None]) * g[:, None]
    p32[torch.arange(n), labels] -= g
    assert int((p32.to(torch.bfloat16).float() != pc).sum()) > 0
