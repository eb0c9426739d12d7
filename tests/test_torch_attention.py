"""Attention of the PyTorch port against the JAX package on the CPU, f32:
the plain version of the attention kernel against the TPU kernel
`fused_attention` (under the Pallas interpreter), the mask helpers, and
`MultiHeadAttention` against the flax module with converted weights. The
CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.ops import masks as jmasks
from deepsc_gan_tpu.ops.attention import MultiHeadAttention as FlaxMHA
from deepsc_gan_tpu.ops.pallas.attention import (
    fused_attention as jax_fused_attention,
    set_attn_kernel_mode,
)
from deepsc_gan_tpu.ops.positional import positional_encoding as jax_pe
from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import masks as tmasks
from deepsc_gan_tpu_torch.ops.attention import MultiHeadAttention, mask_to_bias
from deepsc_gan_tpu_torch.ops.positional import positional_encoding
from deepsc_gan_tpu_torch.utils.convert import flax_to_state_dict


def _inputs(seed, b, lq, lk, h, dh, p_block=0.3):
    rng = np.random.default_rng(seed)
    hd = h * dh
    q = rng.standard_normal((b, lq, hd), np.float32)
    k = rng.standard_normal((b, lk, hd), np.float32)
    v = rng.standard_normal((b, lk, hd), np.float32)
    bias = np.where(rng.random((b, lq, lk)) < p_block, -1e9, 0.0)
    bias = bias.astype(np.float32)
    bias[0, min(1, lq - 1), :] = -1e9  # one query row with every key blocked
    return q, k, v, bias


@pytest.mark.parametrize("shape", [(3, 12, 12, 2, 8), (2, 11, 12, 2, 8),
                                   (2, 31, 32, 8, 16)])
def test_attention_reference_matches_jax_kernel(shape):
    b, lq, lk, h, dh = shape
    q, k, v, bias = _inputs(0, b, lq, lk, h, dh)
    scale = float(np.sqrt(dh))
    set_attn_kernel_mode("interpret")
    try:
        want = np.asarray(jax_fused_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(bias), h, scale))
    finally:
        set_attn_kernel_mode("auto")
    got = attn.attention_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias), h, scale).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    # the fully blocked row: near-uniform weights over all keys, as K1
    np.testing.assert_allclose(got[0, 1], want[0, 1], atol=2e-6)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(1, 2, 5, 6, 2, 4))
    attn.reset_launches()
    out = attn.fused_attention(q, k, v, bias, 2, 2.0)
    ref = attn.attention_fwd_reference(q, k, v, bias, 2, 2.0)
    assert torch.equal(out, ref)
    assert attn.launches == 0


def test_masks_and_positional_encoding_match_jax():
    rng = np.random.default_rng(2)
    inp = rng.integers(0, 4, size=(3, 9)).astype(np.int32)
    tar = inp[:, :-1]
    for w, g in zip(jmasks.create_masks(jnp.asarray(inp), jnp.asarray(tar)),
                    tmasks.create_masks(torch.from_numpy(inp),
                                        torch.from_numpy(tar))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        positional_encoding(50, 16).numpy(), np.asarray(jax_pe(50, 16)))


@pytest.mark.parametrize("kind", ["pad", "causal", "combined", "none"])
def test_mask_to_bias_matches_jax_bias(kind):
    """The bias the JAX module hands its kernel (ops/attention.py:170-178)."""
    rng = np.random.default_rng(3)
    b, lq, lk = 3, 7, 7
    seq = rng.integers(0, 3, size=(b, lk)).astype(np.int32)
    mask = {"pad": jmasks.create_padding_mask(jnp.asarray(seq)),
            "causal": jmasks.create_look_ahead_mask(lq),
            "combined": jnp.maximum(
                jmasks.create_padding_mask(jnp.asarray(seq)),
                jmasks.create_look_ahead_mask(lq)),
            "none": None}[kind]
    if mask is None:
        want = np.zeros((b, lq, lk), np.float32)
    else:
        mb = mask.astype(jnp.float32) * -1e9
        want = np.asarray(jnp.broadcast_to(
            mb, (b, 1, lq, lk) if mb.ndim == 4 else (b, lq, lk)
        ).reshape(b, lq, lk))
    got = mask_to_bias(None if mask is None else torch.tensor(
        np.asarray(mask)), b, lq, lk)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["interpret", "xla"])
@pytest.mark.parametrize("cross", [False, True])
def test_multi_head_attention_matches_flax(mode, cross):
    """Flax module (kernel path under the interpreter, and the einsum path)
    vs the port's module with converted weights: self-attention with the
    combined mask, cross-attention with the padding mask."""
    b, lq, lk, d, h = 3, 10, 12 if cross else 10, 16, 4
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, lq, d), np.float32)
    mem = rng.standard_normal((b, lk, d), np.float32) if cross else x
    seq = np.ones((b, lk), np.int32)
    seq[0, 7:] = 0
    seq[2, 3:] = 0
    pad = jmasks.create_padding_mask(jnp.asarray(seq))
    mask = pad if cross else jnp.maximum(
        pad, jmasks.create_look_ahead_mask(lq))
    mha = FlaxMHA(d_model=d, num_heads=h)
    set_attn_kernel_mode(mode)
    try:
        params = mha.init(jax.random.PRNGKey(5), jnp.asarray(x),
                          jnp.asarray(mem), jnp.asarray(mem), mask)
        want = np.asarray(mha.apply(params, jnp.asarray(x), jnp.asarray(mem),
                                    jnp.asarray(mem), mask))
    finally:
        set_attn_kernel_mode("auto")
    port = MultiHeadAttention(d, h)
    port.load_state_dict(flax_to_state_dict(params["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mem),
                   torch.from_numpy(mem),
                   torch.tensor(np.asarray(mask))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _ok_args(dtype=torch.bfloat16, n=2, lq=31, lk=32, h=8, dh=16):
    q = torch.zeros((n, lq, h * dh), dtype=dtype)
    k = torch.zeros((n, lk, h * dh), dtype=dtype)
    return q, k, k.clone(), torch.zeros((n, lq, lk)), h


@pytest.mark.parametrize("bad", ["dtype", "bias_dtype", "head_dim", "heads",
                                 "length", "contiguous", "aligned", "shape"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """The checks the wrapper makes before a launch (they run on any
    device; here on CPU tensors)."""
    attn._check(*_ok_args())
    q, k, v, bias, h = _ok_args()
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "bias_dtype":
        bias = bias.double()
    elif bad == "head_dim":  # heads of width 0
        q, k, v, bias, h = _ok_args(h=1, dh=0)
    elif bad == "heads":  # a head count that does not divide H * Dh = 128
        h = 3
    elif bad == "length":  # k and v of different lengths
        v = v[:, :-1].contiguous()
    elif bad == "contiguous":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "aligned":
        q = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    elif bad == "shape":
        bias = bias[:, :, :-1].contiguous()
    with pytest.raises((TypeError, ValueError)):
        attn._check(q, k, v, bias, h)


@pytest.mark.parametrize("h,dh", [(2, 64), (32, 8), (8, 24), (4, 256),
                                  (3, 1), (17, 16), (1, 512), (2, 320)])
def test_kernel_wrapper_takes_any_head_width_and_count(h, dh):
    """Head widths other than 8, 16 and 32, past 256 too, and more than 16
    heads, pass the wrapper's checks and go to the wide kernels on the
    card; the tuned widths and counts stay on the tuned kernels."""
    attn._check(*_ok_args(h=h, dh=dh))
    assert attn.is_wide(h, dh) and attn.takes_head_dim(dh)
    assert not attn.is_wide(16, 32) and not attn.is_wide(8, 16)
    assert attn.takes_head_dim(257) and not attn.takes_head_dim(0)


@pytest.mark.parametrize("lq,lk", [(33, 33), (31, 64), (64, 31),
                                   (256, 256)])
def test_kernel_wrapper_takes_any_length(lq, lk):
    """Past 32 queries or keys the wrapper's checks pass (the long-length
    kernels take the call on the card)."""
    attn._check(*_ok_args(lq=lq, lk=lk))
    assert attn.is_long(lq, lk) and not attn.is_long(32, 31)


@pytest.mark.parametrize("shape", [(4, 8, 8, 2, 8), (4, 7, 9, 2, 8),
                                   (6, 1, 12, 3, 4), (2, 31, 32, 8, 16),
                                   (1, 63, 64, 8, 16), (1, 128, 128, 8, 16)])
def test_attention_bwd_reference_matches_jax_kernel(shape):
    """The plain backward (K2's plain version) against jax.grad through the
    TPU kernel's custom VJP (under the Pallas interpreter), and against
    torch.autograd through the plain forward: dq, dk, dv and dbias of
    sum(sin(out)), at the shapes of tests/test_ops.py's kernel test (Lq !=
    Lk included), the decoder cross-attention's, and past 32 queries and
    keys (63 x 64, `cli train --seq-len 64`'s decoder cross-attention, and
    128 x 128: the resident kernel's lengths on the card)."""
    b, lq, lk, h, dh = shape
    q, k, v, bias = _inputs(5, b, lq, lk, h, dh)
    scale = float(np.sqrt(dh))
    set_attn_kernel_mode("interpret")
    try:
        out, vjp = jax.vjp(
            lambda *a: jax_fused_attention(*a, h, scale),
            *(jnp.asarray(a) for a in (q, k, v, bias)))
        g = np.cos(np.asarray(out))
        want = vjp(jnp.asarray(g))
    finally:
        set_attn_kernel_mode("auto")
    got = attn.attention_bwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), torch.from_numpy(g),
        h, scale)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    torch.sin(attn.attention_fwd_reference(*leaves, h, scale)).sum() \
        .backward()
    for name, gt, w, auto in zip("qkvb", got, want, leaves):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), atol=2e-6,
                                   err_msg=f"d{name} vs JAX")
        np.testing.assert_allclose(gt.numpy(), auto.grad.numpy(), atol=2e-6,
                                   err_msg=f"d{name} vs autograd")


@pytest.mark.parametrize("plain", [False, True])
def test_fused_attention_function_backward(plain):
    """The autograd Function: the CPU backward is the plain version's, the
    bias gets a gradient only when it needs one, no kernel launch is
    counted on the CPU."""
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(6, 3, 9, 10, 2, 8))
    fn = attn.plain_attention if plain else attn.fused_attention
    attn.reset_launches()
    for bias_grad in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        bt = bias.clone().requires_grad_(bias_grad)
        out = fn(*leaves, bt, 2, 4.0)
        g = torch.cos(out.detach())
        out.backward(g)
        want = attn.attention_bwd_reference(q, k, v, bias, g, 2, 4.0,
                                            bias_grad)
        for t, w in zip(leaves, want[:3]):
            torch.testing.assert_close(t.grad, w, rtol=0, atol=0)
        if bias_grad:
            torch.testing.assert_close(bt.grad, want[3], rtol=0, atol=0)
        else:
            assert bt.grad is None and want[3] is None
    assert attn.launches == 0 and attn.bwd_launches == 0


@pytest.mark.parametrize("shape", [(2, 31, 31, 8, 25), (2, 32, 32, 8, 64),
                                   (2, 31, 32, 3, 5), (2, 31, 31, 2, 320),
                                   (2, 32, 32, 1, 264)])
def test_wide_attention_reference_matches_jax_kernel(shape):
    """The plain K1 and K2 against the TPU kernel and its custom VJP (under
    the Pallas interpreter, one jax.vjp for both) at the widths the
    tensor-core wide and chunked kernels take on the card: the widened
    model's decoder (8 heads of 25) and encoder (8 of 64), 3 heads of 5
    (widths off the mma k-step, whose head slices start off 16 bytes), the
    wide-heads decoder (2 heads of 320) and one head of 264 (past 256, off
    the k-step); out, dq, dk, dv and
    dbias of sum(sin(out)), with a fully blocked row. f32, as
    test_attention_bwd_reference_matches_jax_kernel, within 2e-6 of the
    largest value of each (XLA and PyTorch sum the products of 64-wide
    heads in other orders)."""
    b, lq, lk, h, dh = shape
    q, k, v, bias = _inputs(7, b, lq, lk, h, dh)
    scale = float(np.sqrt(dh))
    set_attn_kernel_mode("interpret")
    try:
        out, vjp = jax.vjp(
            lambda *a: jax_fused_attention(*a, h, scale),
            *(jnp.asarray(a) for a in (q, k, v, bias)))
        g = np.cos(np.asarray(out))
        want = [np.asarray(out)] + [np.asarray(w) for w in
                                    vjp(jnp.asarray(g))]
    finally:
        set_attn_kernel_mode("auto")
    ts = [torch.from_numpy(a) for a in (q, k, v, bias)]
    got = [attn.attention_fwd_reference(*ts, h, scale)]
    got += attn.attention_bwd_reference(*ts, torch.from_numpy(g), h, scale)
    for name, gt, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        assert gt.shape == w.shape, name
        np.testing.assert_allclose(gt.numpy(), w,
                                   atol=2e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    # the fully blocked row: near-uniform weights over all keys, as K1
    assert np.abs(got[0][0, 1].numpy() - v[0].mean(axis=0)).max() < 1e-5


@pytest.mark.parametrize("dtype,h,dh,mma", [
    (torch.bfloat16, 8, 64, True), (torch.bfloat16, 8, 25, True),
    (torch.bfloat16, 32, 16, True), (torch.bfloat16, 3, 5, True),
    (torch.bfloat16, 1, 256, True), (torch.bfloat16, 1, 257, False),
    (torch.bfloat16, 2, 320, False), (torch.bfloat16, 8, 16, False),
    (torch.float32, 8, 64, False), (torch.float32, 8, 25, False),
    (torch.float32, 32, 16, False), (torch.float32, 1, 256, False)])
def test_wide_mma_routing(dtype, h, dh, mma):
    """K1 and K2 in bf16 at every wide shape up to 256-wide heads, any head
    count, run the tensor-core wide kernels (csrc/attention_wide_mma.cu);
    257 and wider stay on the chunked kernels, the tuned shapes on the
    tuned kernels, and f32 never goes (it keeps exact f32 sums on the CUDA
    cores: the forward csrc/attention_tiled.cu, the backward
    csrc/attention_bwd_tiled.cu)."""
    assert attn.is_wide_mma(dtype, h, dh) == mma
    assert not (mma and attn.is_chunked_mma(dtype, h, dh))
    if mma:
        assert attn.is_wide(h, dh)


@pytest.mark.parametrize("dtype,h,dh,chunked", [
    (torch.bfloat16, 2, 320, True), (torch.bfloat16, 1, 512, True),
    (torch.bfloat16, 1, 257, True), (torch.bfloat16, 1, 256, False),
    (torch.bfloat16, 8, 64, False), (torch.float32, 2, 320, False),
    (torch.bfloat16, 1, 300, True), (torch.bfloat16, 1, 1024, True),
    (torch.float32, 1, 512, False), (torch.float32, 1, 300, False)])
def test_chunked_mma_routing(dtype, h, dh, chunked):
    """The bf16 K1 and K2 at heads wider than 256 run the tensor-core
    chunked kernels (csrc/attention_chunked.cu); f32 (the tiled kernels of
    csrc/attention_tiled.cu and csrc/attention_bwd_tiled.cu) and narrower
    heads do not."""
    assert attn.is_chunked_mma(dtype, h, dh) == chunked


@pytest.mark.parametrize("dtype,h,dh,tiled", [
    (torch.float32, 8, 25, True), (torch.float32, 8, 64, True),
    (torch.float32, 32, 16, True), (torch.float32, 8, 24, True),
    (torch.float32, 8, 128, True), (torch.float32, 1, 512, True),
    (torch.float32, 2, 320, True), (torch.float32, 1, 300, True),
    (torch.float32, 17, 8, True), (torch.float32, 3, 5, True),
    (torch.float32, 8, 16, False), (torch.float32, 16, 32, False),
    (torch.float32, 2, 8, False), (torch.bfloat16, 8, 25, False),
    (torch.bfloat16, 1, 512, False), (torch.bfloat16, 8, 16, False)])
def test_tiled_routing(dtype, h, dh, tiled):
    """The f32 K1 and K2 at every head width and count the tuned kernels do
    not take (widths off 8, 16 and 32, more than 16 heads, heads past 256)
    run the tiled kernels (csrc/attention_tiled.cu,
    csrc/attention_bwd_tiled.cu), at any length (never the resident or
    cluster K2, which are bf16's); the f32 tuned shapes go to the narrow
    kernels (csrc/attention_narrow.cu) and bf16 to its tensor-core
    kernels."""
    assert attn.uses_tiled(dtype, h, dh) == tiled
    assert tiled == (dtype == torch.float32 and attn.is_wide(h, dh))
    assert attn.uses_narrow(dtype, h, dh) == (dtype == torch.float32
                                              and not tiled)
    for lq, lk in ((31, 31), (31, 32), (70, 97), (300, 300)):
        assert not (tiled and (attn.uses_resident(dtype, lq, lk, h, dh)
                               or attn.uses_cluster(dtype, lq, lk, h, dh)))


def _fma(a, b, c):
    """f32 fmaf(a, b, c), emulated: the exact product and sum in f64 (a
    product of two f32 values is exact there), rounded once to f32."""
    return (a.double() * b.double() + c.double()).float()


def _tiled_forward(q, k, v, bias, heads, scale):
    """The tiled f32 K1's arithmetic in its order (csrc/attention_tiled.cu)
    on CPU tensors: each logit a sum over d in order 0..Dh-1 by fmaf, times
    1/scale (rounded once to f32), plus its bias; a row's max, exp(s - max)
    and their sum over 32 lanes (lane l takes keys l, l + 32, ... in order,
    then a butterfly of five steps), p = e / sum; each output a sum over the
    keys in order by fmaf."""
    n, lq, hd = q.shape
    lk, dh = k.shape[1], hd // heads
    inv = torch.tensor(1.0 / scale, dtype=torch.float64).float()
    out = torch.empty_like(q)
    for h in range(heads):
        qh, kh, vh = (t[:, :, h * dh:(h + 1) * dh] for t in (q, k, v))
        s = torch.zeros((n, lq, lk))
        for d in range(dh):
            s = _fma(qh[:, :, d, None], kh[:, None, :, d], s)
        s = s * inv + bias
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        lanes = torch.zeros((n, lq, 32))
        for j in range(lk):
            lanes[..., j % 32] += e[..., j]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[..., torch.arange(32) ^ o]
        p = e / lanes[..., :1]
        acc = torch.zeros((n, lq, dh))
        for j in range(lk):
            acc = _fma(p[..., j, None], vh[:, None, j, :], acc)
        out[:, :, h * dh:(h + 1) * dh] = acc
    return out


@pytest.mark.parametrize("shape", [(2, 31, 31, 8, 25), (2, 32, 32, 8, 64),
                                   (2, 31, 32, 2, 320), (1, 5, 70, 1, 300),
                                   (2, 7, 9, 3, 5)])
def test_tiled_forward_emulation_matches_plain_version(shape):
    """The tiled f32 K1's order of sums and roundings (`_tiled_forward`)
    against the plain version within 1e-5, as chip_smoke.py holds the
    kernel, at the widened model's heads (8 of 25, 8 of 64), the wide-heads
    decoder's (2 of 320), one head of 300 past 64 keys (two of the
    kernel's key chunks) and 3 heads of 5, with a fully blocked row; and
    against the TPU kernel under the Pallas interpreter within the same."""
    b, lq, lk, h, dh = shape
    q, k, v, bias = _inputs(9, b, lq, lk, h, dh)
    scale = float(np.sqrt(dh))
    ts = [torch.from_numpy(a) for a in (q, k, v, bias)]
    got = _tiled_forward(*ts, h, scale)
    want = attn.attention_fwd_reference(*ts, h, scale)
    assert (got - want).abs().max().item() <= 1e-5
    set_attn_kernel_mode("interpret")
    try:
        jax_out = np.asarray(jax_fused_attention(
            *(jnp.asarray(a) for a in (q, k, v, bias)), h, scale))
    finally:
        set_attn_kernel_mode("auto")
    assert np.abs(got.numpy() - jax_out).max() <= 1e-5


@pytest.mark.parametrize("n,lq,lk,heads,dbias,floats", [
    (64, 31, 31, 2, False, 2 * 64 * 2 * 31 * 31),
    (64, 31, 31, 2, True, 3 * 64 * 2 * 31 * 31),
    (2, 20, 3000, 1, False, 2 * 2 * 20 * 3000)])
def test_tiled_bwd_scratch(n, lq, lk, heads, dbias, floats):
    """The tiled K2's scratch: each head's p and dss (N, H, Lq, Lk), and ds
    too with dbias."""
    assert attn.tiled_bwd_scratch_floats(n, lq, lk, heads, dbias) == floats


def _tiled_backward(q, k, v, bias, g, heads, scale, need_dbias):
    """The tiled f32 K2's arithmetic in its order
    (csrc/attention_bwd_tiled.cu) on CPU tensors: each logit and each dp a
    sum over d in order 0..Dh-1 by fmaf, the logit times 1/scale (rounded
    once to f32) plus its bias; a row's max, exp(s - max) and their sum
    over 32 lanes (lane l takes keys l, l + 32, ... in order, then a
    butterfly of five steps), p = e / sum, rowsum = sum_j p_j dp_j over the
    lanes the same way by fmaf; ds = p (dp - rowsum), dss = ds (1/scale);
    dq a sum over the keys in order by fmaf, dk and dv over the queries;
    dbias the heads' ds added in order 0..H-1."""
    n, lq, hd = q.shape
    lk, dh = k.shape[1], hd // heads
    inv = torch.tensor(1.0 / scale, dtype=torch.float64).float()
    grads = [torch.empty_like(t) for t in (q, k, v)]
    dbias = torch.zeros((n, lq, lk))
    lane = torch.arange(32)

    def lanes_sum(x, y=None):
        acc = torch.zeros((n, lq, 32))
        for j in range(lk):
            acc[..., j % 32] = (acc[..., j % 32] + x[..., j] if y is None
                                else _fma(x[..., j], y[..., j],
                                          acc[..., j % 32]))
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[..., lane ^ o]
        return acc[..., :1]

    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        qh, kh, vh, gh = (t[:, :, cols] for t in (q, k, v, g))
        s = torch.zeros((n, lq, lk))
        dp = torch.zeros((n, lq, lk))
        for d in range(dh):
            s = _fma(qh[:, :, d, None], kh[:, None, :, d], s)
            dp = _fma(gh[:, :, d, None], vh[:, None, :, d], dp)
        s = s * inv + bias
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / lanes_sum(e)
        ds = p * (dp - lanes_sum(p, dp))
        dss = ds * inv
        dq = torch.zeros((n, lq, dh))
        for j in range(lk):
            dq = _fma(dss[..., j, None], kh[:, None, j, :], dq)
        dk = torch.zeros((n, lk, dh))
        dv = torch.zeros((n, lk, dh))
        for i in range(lq):
            dk = _fma(dss[:, i, :, None], qh[:, i, None, :], dk)
            dv = _fma(p[:, i, :, None], gh[:, i, None, :], dv)
        for grad, part in zip(grads, (dq, dk, dv)):
            grad[:, :, cols] = part
        dbias = dbias + ds
    return (*grads, dbias if need_dbias else None)


_JAX_VJPS = {}


def _jax_attention_vjp(shape):
    """(q, k, v, bias, g, [dq, dk, dv, dbias]) of the TPU kernel's custom
    VJP under the Pallas interpreter, g = cos(out), once per shape."""
    if shape not in _JAX_VJPS:
        b, lq, lk, h, dh = shape
        q, k, v, bias = _inputs(11, b, lq, lk, h, dh)
        scale = float(np.sqrt(dh))
        set_attn_kernel_mode("interpret")
        try:
            out, vjp = jax.vjp(
                lambda *a: jax_fused_attention(*a, h, scale),
                *(jnp.asarray(a) for a in (q, k, v, bias)))
            g = np.cos(np.asarray(out))
            want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
        finally:
            set_attn_kernel_mode("auto")
        _JAX_VJPS[shape] = (q, k, v, bias, g, want)
    return _JAX_VJPS[shape]


@pytest.mark.parametrize("shape", [(2, 31, 31, 8, 25), (2, 32, 32, 8, 64),
                                   (2, 31, 32, 2, 320), (1, 5, 70, 1, 300),
                                   (2, 7, 9, 3, 5)])
@pytest.mark.parametrize("dbias", [False, True])
def test_tiled_backward_emulation_matches_plain_version(shape, dbias):
    """The tiled f32 K2's order of sums and roundings (`_tiled_backward`)
    at the widened model's heads (8 of 25, 8 of 64), the wide-heads
    decoder's (2 of 320), one head of 300 past 64 keys (several of the
    kernel's key chunks) and 3 heads of 5, with a fully blocked row, with
    and without dbias: dq, dk, dv within 1e-5 of the plain version's and of
    the TPU kernel's VJP (under the Pallas interpreter), and dbias within
    1e-5 of its largest value (a sum over the heads of p (dp - rowsum),
    where dp is a dot of Dh products); dq, dk and dv the same bits with and
    without dbias."""
    b, lq, lk, h, dh = shape
    q, k, v, bias, g, jax_grads = _jax_attention_vjp(shape)
    scale = float(np.sqrt(dh))
    ts = [torch.from_numpy(a) for a in (q, k, v, bias, g)]
    got = _tiled_backward(*ts, h, scale, dbias)
    want = attn.attention_bwd_reference(*ts, h, scale, dbias)
    for name, a, r, j in zip(("dq", "dk", "dv", "dbias"), got, want,
                             jax_grads):
        if name == "dbias" and not dbias:
            assert a is None and r is None
            continue
        tol = 1e-5 * (r.abs().max().item() if name == "dbias" else 1.0)
        assert (a - r).abs().max().item() <= tol, name
        assert np.abs(a.numpy() - j).max() <= tol, name
    other = _tiled_backward(*ts, h, scale, not dbias)
    assert all(torch.equal(x, y) for x, y in zip(got[:3], other[:3]))


@pytest.mark.parametrize("dtype,h,dh,narrow", [
    (torch.float32, 8, 16, True), (torch.float32, 16, 16, True),
    (torch.float32, 16, 32, True), (torch.float32, 2, 8, True),
    (torch.float32, 1, 32, True), (torch.float32, 17, 8, False),
    (torch.float32, 8, 24, False), (torch.float32, 8, 64, False),
    (torch.bfloat16, 8, 16, False), (torch.bfloat16, 16, 32, False)])
def test_narrow_routing(dtype, h, dh, narrow):
    """Every f32 K1 and K2 at the tuned heads (8, 16 or 32 wide, at most
    16) runs the narrow kernels (csrc/attention_narrow.cu), at every length
    (never the resident, cluster, tiled or tensor-core kernels); other f32
    heads the tiled kernels, bf16 its own."""
    assert attn.uses_narrow(dtype, h, dh) == narrow
    for lq, lk in ((31, 31), (32, 32), (31, 32), (63, 64), (128, 128),
                   (1, 300), (300, 1)):
        assert not (narrow and (
            attn.uses_resident(dtype, lq, lk, h, dh)
            or attn.uses_cluster(dtype, lq, lk, h, dh)
            or attn.uses_tiled(dtype, h, dh)
            or attn.is_wide_mma(dtype, h, dh)
            or attn.is_chunked_mma(dtype, h, dh)))


@pytest.mark.parametrize("n,lq,lk,heads,dbias,floats", [
    (64, 31, 31, 8, False, 0), (64, 32, 32, 8, True, 64 * 8 * 32 * 32),
    (64, 128, 128, 8, False, 4 * 64 * 8 * 128),
    (64, 63, 64, 8, True, 64 * 8 * 63 * (4 + 64)),
    (2, 5, 70, 2, True, 2 * 2 * 5 * (4 + 70)),
    (2, 129, 20, 2, False, 4 * 2 * 2 * 129),
    (1, 5, 300, 1, True, 5 * (4 + 300))])
def test_narrow_bwd_scratch(n, lq, lk, heads, dbias, floats):
    """The narrow K2's scratch: the row statistics (N, H, Lq, 4) past
    TILE queries or keys (the pair of kernels), and each head's ds (N, H,
    Lq, Lk) with dbias; none up to TILE of both without dbias."""
    assert attn.narrow_bwd_scratch_floats(n, lq, lk, heads, dbias) == floats


# the narrow kernels' tiles (csrc/attention_narrow.cu): 32 keys (or
# queries), a quad of lanes a row, lane c taking rows c, c + 4, ... of a
# tile
_NT, _NL = 32, 4


def _quad_sum(parts):
    """The quad's butterfly of two shuffles over its lanes' partials (the
    last axis, 4): lane 0's (p0 + p1) + (p2 + p3), which every lane
    gets."""
    return (parts[..., 0] + parts[..., 1]) + (parts[..., 2] + parts[..., 3])


def _lanes(x, fma_with=None):
    """Each lane's partial over its columns c, c + 4, ... of a tile (the
    last axis) in order, added (or, with `fma_with`, fmaf(x, y, acc)) ->
    (..., 4)."""
    acc = torch.zeros((*x.shape[:-1], _NL))
    for j in range(x.shape[-1]):
        c = j % _NL
        acc[..., c] = (acc[..., c] + x[..., j] if fma_with is None
                       else _fma(x[..., j], fma_with[..., j], acc[..., c]))
    return acc


def _dots(a, b, dh):
    """a_i . b_j over d in order 0..Dh-1 by fmaf: (n, L, dh) x (n, M, dh)
    -> (n, L, M)."""
    acc = torch.zeros((a.shape[0], a.shape[1], b.shape[1]))
    for d in range(dh):
        acc = _fma(a[:, :, d, None], b[:, None, :, d], acc)
    return acc


def _narrow_forward(q, k, v, bias, heads, scale):
    """The narrow f32 K1's arithmetic in its order (csrc/attention_narrow.cu)
    on CPU tensors: each logit a sum over d in order by fmaf, times 1/scale
    (rounded once to f32), plus its bias; the keys in tiles of 32, each
    lane's partial sum over its keys in order, the quad's butterfly. One
    tile: p = e / sum, out = sum over the keys of p v in order by fmaf.
    More: the running max m and sum l = l alpha + the tile's sum, the
    context rescaled by alpha = exp(m_old - m_new) and summed over the
    tile's keys e v in order by fmaf, then out = context / l."""
    n, lq, hd = q.shape
    lk, dh = k.shape[1], hd // heads
    inv = torch.tensor(1.0 / scale, dtype=torch.float64).float()
    out = torch.empty_like(q)
    tiles = range(0, lk, _NT)
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        qh, kh, vh = (t[:, :, cols] for t in (q, k, v))
        s = _dots(qh, kh, dh) * inv + bias
        ctx = torch.zeros((n, lq, dh))
        m = torch.full((n, lq), -float("inf"))
        l = torch.zeros((n, lq))
        for k0 in tiles:
            st = s[..., k0:k0 + _NT]
            if len(tiles) == 1:
                e = torch.exp(st - st.amax(dim=-1, keepdim=True))
                w = e / _quad_sum(_lanes(e))[..., None]
            else:
                mn = torch.maximum(m, st.amax(dim=-1))
                alpha = torch.exp(m - mn)
                w = torch.exp(st - mn[..., None])
                l = l * alpha + _quad_sum(_lanes(w))
                ctx = ctx * alpha[..., None]
                m = mn
            for j in range(st.shape[-1]):
                ctx = _fma(w[..., j, None], vh[:, None, k0 + j, :], ctx)
        out[:, :, cols] = ctx if len(tiles) == 1 else ctx / l[..., None]
    return out


def _narrow_backward(q, k, v, bias, g, heads, scale, need_dbias):
    """The narrow f32 K2's arithmetic in its order (csrc/attention_narrow.cu)
    on CPU tensors: each logit and each dp a sum over d in order by fmaf.
    Up to 32 queries and keys (one kernel): the row's max, e and its sum
    over the lanes and the quad's butterfly, p = e / sum, rowsum = sum of
    p dp by fmaf the same way, ds = p (dp - rowsum), dss = ds (1/scale).
    Past 32 (one kernel holding a row's head up to 128 of both, two past
    them, with the same operations in the same order): the statistics over
    the key tiles (the running max m, l = l alpha + the tile's sum of e,
    racc = racc alpha + the tile's sum of e dp by fmaf, rowsum = racc / l),
    then p = exp(s - m) / l. dq a sum over the keys in order by fmaf, dk
    and dv over the queries; dbias the heads' ds added in order 0..H-1."""
    n, lq, hd = q.shape
    lk, dh = k.shape[1], hd // heads
    inv = torch.tensor(1.0 / scale, dtype=torch.float64).float()
    grads = [torch.empty_like(t) for t in (q, k, v)]
    dbias = torch.zeros((n, lq, lk))
    long = lq > _NT or lk > _NT
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        qh, kh, vh, gh = (t[:, :, cols] for t in (q, k, v, g))
        s = _dots(qh, kh, dh) * inv + bias
        dp = _dots(gh, vh, dh)
        if not long:
            e = torch.exp(s - s.amax(dim=-1, keepdim=True))
            p = e / _quad_sum(_lanes(e))[..., None]
            rowsum = _quad_sum(_lanes(p, dp))
        else:
            m = torch.full((n, lq), -float("inf"))
            l = torch.zeros((n, lq))
            racc = torch.zeros((n, lq))
            for k0 in range(0, lk, _NT):
                st, dpt = s[..., k0:k0 + _NT], dp[..., k0:k0 + _NT]
                mn = torch.maximum(m, st.amax(dim=-1))
                alpha = torch.exp(m - mn)
                e = torch.exp(st - mn[..., None])
                l = l * alpha + _quad_sum(_lanes(e))
                racc = racc * alpha + _quad_sum(_lanes(e, dpt))
                m = mn
            rowsum = racc / l
            p = torch.exp(s - m[..., None]) / l[..., None]
        ds = p * (dp - rowsum[..., None])
        dss = ds * inv
        dq = torch.zeros((n, lq, dh))
        for j in range(lk):
            dq = _fma(dss[..., j, None], kh[:, None, j, :], dq)
        dk = torch.zeros((n, lk, dh))
        dv = torch.zeros((n, lk, dh))
        for i in range(lq):
            dk = _fma(dss[:, i, :, None], qh[:, i, None, :], dk)
            dv = _fma(p[:, i, :, None], gh[:, i, None, :], dv)
        for grad, part in zip(grads, (dq, dk, dv)):
            grad[:, :, cols] = part
        dbias = dbias + ds
    return (*grads, dbias if need_dbias else None)


# the narrow kernels' shapes: the main model's 8 heads of 16 at the
# training lengths, 2 heads of 8 (with the fully blocked row every input
# has), 16 heads of 16, 8 of 32 at the seq-len-64 epoch's 63 x 64, and a
# row of keys past two tiles (70: tiles of 32, 32 and 6)
NARROW_SHAPES = [(2, 31, 31, 8, 16), (2, 32, 32, 8, 16), (2, 31, 32, 8, 16),
                 (2, 7, 9, 2, 8), (1, 31, 31, 16, 16), (1, 63, 64, 8, 32),
                 (2, 5, 70, 2, 8)]


@pytest.mark.parametrize("shape", NARROW_SHAPES)
def test_narrow_forward_emulation_matches_plain_version(shape):
    """The narrow f32 K1's order of sums and roundings (`_narrow_forward`:
    the lanes and their butterfly, the key tiles, the online rescale past
    one tile) against the plain version within 1e-5, as chip_smoke.py holds
    the kernel, and against the TPU kernel under the Pallas interpreter
    within the same."""
    b, lq, lk, h, dh = shape
    q, k, v, bias = _inputs(9, b, lq, lk, h, dh)
    scale = float(np.sqrt(dh))
    ts = [torch.from_numpy(a) for a in (q, k, v, bias)]
    got = _narrow_forward(*ts, h, scale)
    want = attn.attention_fwd_reference(*ts, h, scale)
    assert (got - want).abs().max().item() <= 1e-5
    set_attn_kernel_mode("interpret")
    try:
        jax_out = np.asarray(jax_fused_attention(
            *(jnp.asarray(a) for a in (q, k, v, bias)), h, scale))
    finally:
        set_attn_kernel_mode("auto")
    assert np.abs(got.numpy() - jax_out).max() <= 1e-5


@pytest.mark.parametrize("shape", NARROW_SHAPES)
@pytest.mark.parametrize("dbias", [False, True])
def test_narrow_backward_emulation_matches_plain_version(shape, dbias):
    """The narrow f32 K2's order of sums and roundings (`_narrow_backward`:
    one kernel up to 32 queries and keys, past them the statistics pair)
    with and without dbias: dq, dk, dv within 1e-5 of the plain version's
    and of the TPU kernel's VJP (under the Pallas interpreter), dbias within
    1e-5 of its largest value; dq, dk and dv the same bits with and without
    dbias."""
    b, lq, lk, h, dh = shape
    q, k, v, bias, g, jax_grads = _jax_attention_vjp(shape)
    scale = float(np.sqrt(dh))
    ts = [torch.from_numpy(a) for a in (q, k, v, bias, g)]
    got = _narrow_backward(*ts, h, scale, dbias)
    want = attn.attention_bwd_reference(*ts, h, scale, dbias)
    for name, a, r, j in zip(("dq", "dk", "dv", "dbias"), got, want,
                             jax_grads):
        if name == "dbias" and not dbias:
            assert a is None and r is None
            continue
        tol = 1e-5 * (r.abs().max().item() if name == "dbias" else 1.0)
        assert (a - r).abs().max().item() <= tol, name
        assert np.abs(a.numpy() - j).max() <= tol, name
    other = _narrow_backward(*ts, h, scale, not dbias)
    assert all(torch.equal(x, y) for x, y in zip(got[:3], other[:3]))


@pytest.mark.parametrize("dtype,lq,lk,h,dh,resident", [
    (torch.bfloat16, 33, 33, 8, 16, True), (torch.bfloat16, 64, 64, 8, 16,
                                            True),
    (torch.bfloat16, 128, 128, 8, 16, True), (torch.bfloat16, 63, 64, 8, 16,
                                              True),
    (torch.bfloat16, 128, 31, 16, 8, True), (torch.bfloat16, 20, 100, 4, 32,
                                             True),
    (torch.bfloat16, 129, 129, 8, 16, False), (torch.bfloat16, 64, 200, 8,
                                               16, False),
    (torch.bfloat16, 32, 32, 8, 16, False), (torch.bfloat16, 31, 32, 8, 16,
                                             False),
    (torch.bfloat16, 64, 64, 8, 25, False), (torch.bfloat16, 64, 64, 32, 16,
                                             False),
    (torch.float32, 64, 64, 8, 16, False), (torch.float32, 128, 128, 8, 16,
                                            False)])
def test_resident_routing(dtype, lq, lk, h, dh, resident):
    """The bf16 K2 past 32 queries or keys, up to L_RES of both, at the
    tuned head widths and counts, runs the resident kernel
    (csrc/attention_bwd_resident.cu); longer rows, f32, short lengths and
    wide heads do not."""
    assert attn.uses_resident(dtype, lq, lk, h, dh) == resident
    assert not resident or (attn.is_long(lq, lk)
                            and not attn.is_wide(h, dh))


@pytest.mark.parametrize("dtype,lq,lk,h,dh,cluster", [
    (torch.bfloat16, 129, 129, 8, 16, True), (torch.bfloat16, 256, 256, 8,
                                              16, True),
    (torch.bfloat16, 255, 256, 8, 16, True), (torch.bfloat16, 31, 256, 8,
                                              16, True),
    (torch.bfloat16, 256, 31, 8, 16, True), (torch.bfloat16, 512, 512, 16,
                                             32, True),
    (torch.bfloat16, 64, 200, 8, 16, True), (torch.bfloat16, 300, 8, 2, 8,
                                             True),
    (torch.bfloat16, 128, 128, 8, 16, False), (torch.bfloat16, 513, 64, 8,
                                               16, False),
    (torch.bfloat16, 64, 513, 8, 16, False), (torch.bfloat16, 256, 256, 8,
                                              25, False),
    (torch.bfloat16, 256, 256, 32, 16, False), (torch.float32, 256, 256, 8,
                                                16, False),
    (torch.float32, 129, 129, 8, 16, False)])
def test_cluster_routing(dtype, lq, lk, h, dh, cluster):
    """The bf16 K2 past L_RES queries or keys, up to L_CLUSTER of both, at
    the tuned head widths and counts, runs the cluster kernel
    (csrc/attention_bwd_cluster.cu); up to L_RES the resident kernel, past
    L_CLUSTER, f32 and wide heads the older kernels. No shape takes both."""
    assert attn.uses_cluster(dtype, lq, lk, h, dh) == cluster
    assert not (cluster and attn.uses_resident(dtype, lq, lk, h, dh))
    assert not cluster or (attn.is_long(lq, lk)
                           and not attn.is_wide(h, dh))


@pytest.mark.parametrize("dh", [8, 16, 32])
def test_cluster_plan_fits_the_card(dh):
    """The cluster K2's block (`cluster_plan`, the library's own plan on
    the card: held to it by a card test) fits a block of the H100 at every
    length it takes (one block an SM, 512 threads), its slices (at most
    16) cover the queries, and a slice is a whole number of 16-query
    warps; at 256 keys a slice holds 64 queries, at 512 keys 32."""
    worst = 0
    for lk in list(range(1, 160)) + list(range(160, attn.L_CLUSTER + 1, 7)) \
            + [attn.L_CLUSTER]:
        for lq in (1, 31, 129, 255, 256, 300, attn.L_CLUSTER):
            if not attn.uses_cluster(torch.bfloat16, lq, lk, 8, dh):
                continue
            smem, threads, blocks, rows = attn.cluster_plan(lq, lk, dh)
            worst = max(worst, smem)
            assert threads == 32 * attn.CLUSTER_WARPS == 512
            assert 1 <= blocks <= 16
            assert (blocks - 1) * rows < lq <= blocks * rows
            assert rows % 16 == 0
    assert worst <= BLOCK_SMEM and SM_SMEM // (worst + RESERVED) >= 1
    assert attn.cluster_slice_rows(256) == 64
    assert attn.cluster_slice_rows(512) == 32
    assert attn.cluster_plan(256, 256, dh)[2] == 4
    assert attn.cluster_plan(512, 512, dh)[2] == 16


@pytest.mark.parametrize("n,heads,lq,lk,want", [
    (64, 8, 256, 256, 1), (16, 8, 256, 256, 2), (8, 8, 256, 256, 4),
    (1, 8, 256, 256, 4), (1, 1, 512, 512, 8), (2, 4, 31, 256, 1),
    (4, 8, 512, 256, 8), (132, 1, 512, 512, 1), (8, 16, 129, 129, 2)])
def test_cluster_size(n, heads, lq, lk, want):
    """The cluster K2 splits a row's head over a cluster only where the
    rows' heads are fewer than the H100's 132 SMs: doubled up to
    CLUSTER_MAX blocks (the portable size) and the query slices."""
    assert attn.cluster_size(n, heads, lq, lk, 132) == want
    assert want <= attn.CLUSTER_MAX


# the card's shared memory an SM and a block can use, and what each block
# sets aside (H100: 228 KB an SM, 227 KB a block)
SM_SMEM, BLOCK_SMEM, RESERVED = 233472, 232448, 1024


@pytest.mark.parametrize("dh", [8, 16, 32])
def test_resident_plan_fits_the_card(dh):
    """The resident K2 block's shared memory (`resident_smem_bytes`, the
    library's own plan on the card: held to it by a card test) fits a
    block of the H100 at every length it takes, with at most 256 threads
    (a warp per 16 of the longer side); at 128 x 128 it is built for one
    block an SM (256 threads of up to 255 registers), and its shared
    memory allows that one."""
    worst = 0
    for lq in range(1, attn.L_RES + 1):
        for lk in range(1, attn.L_RES + 1):
            if not attn.is_long(lq, lk):
                continue
            smem = attn.resident_smem_bytes(lq, lk, dh)
            worst = max(worst, smem)
            assert attn.resident_threads(lq, lk) <= 256
    assert worst == attn.resident_smem_bytes(attn.L_RES, attn.L_RES, dh)
    assert worst <= BLOCK_SMEM and SM_SMEM // (worst + RESERVED) >= 1
    assert attn.resident_threads(attn.L_RES, attn.L_RES) == 256
    # the strides keep the fragment loads conflict-free: rows of an odd
    # number of 16-byte units for q, k, v, g and the pc and dss tiles
    units = dh * 2 // 16
    assert (units + (1 if units % 2 == 0 else 2)) % 2 == 1
    for lkp in range(16, attn.L_RES + 1, 16):
        assert ((2 * lkp + 16) // 16) % 2 == 1
