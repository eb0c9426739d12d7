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
    """The C entry points refuse a split that owns no vocab tile."""
    splits = ce.vocab_splits(n, v, sms)
    tiles = -(-v // ce.TILE_V)
    per = -(-tiles // splits)
    assert 1 <= splits <= tiles and (splits - 1) * per < tiles


def _ok_args(dtype=torch.bfloat16, n=4, d=128, v=100):
    return (torch.zeros((n, d), dtype=dtype), torch.zeros((v, d), dtype=dtype),
            torch.zeros(v), torch.zeros(n, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["dtype", "mixed", "width", "wide", "bias",
                                 "labels", "rows", "contiguous", "aligned",
                                 "layout"])
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
    elif bad == "width":
        h, W, b, labels = _ok_args(d=12)
    elif bad == "wide":
        h, W, b, labels = _ok_args(d=264)
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
    with pytest.raises((TypeError, ValueError)):
        ce._check(h, W, b, labels, *rows)


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
