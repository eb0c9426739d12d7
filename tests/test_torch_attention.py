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
    elif bad == "head_dim":
        q, k, v, bias, h = _ok_args(h=2, dh=64)
    elif bad == "heads":
        q, k, v, bias, h = _ok_args(h=32, dh=8)
    elif bad == "length":
        q, k, v, bias, h = _ok_args(lk=33)
    elif bad == "contiguous":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "aligned":
        q = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    elif bad == "shape":
        bias = bias[:, :, :-1].contiguous()
    with pytest.raises((TypeError, ValueError)):
        attn._check(q, k, v, bias, h)


@pytest.mark.parametrize("shape", [(4, 8, 8, 2, 8), (4, 7, 9, 2, 8),
                                   (6, 1, 12, 3, 4), (2, 31, 32, 8, 16)])
def test_attention_bwd_reference_matches_jax_kernel(shape):
    """The plain backward (K2's plain version) against jax.grad through the
    TPU kernel's custom VJP (under the Pallas interpreter), and against
    torch.autograd through the plain forward: dq, dk, dv and dbias of
    sum(sin(out)), at the shapes of tests/test_ops.py's kernel test (Lq !=
    Lk included) and the decoder cross-attention's."""
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
