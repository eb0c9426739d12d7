"""Past 32 queries and keys, on the CPU at f32 against the JAX package: the
attention's plain versions (forward and backward) against the TPU kernel
`fused_attention` under the Pallas interpreter, and the whole vanilla
teacher-forced forward and loss at seq_len 48; on the card the kernels
take these lengths (tests/test_torch_cuda.py), and the check at command
start accepts them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.ops.masks import create_masks as jax_create_masks
from deepsc_gan_tpu.ops.pallas.attention import (
    fused_attention as jax_fused_attention,
    set_attn_kernel_mode,
)
from deepsc_gan_tpu.train import steps as jsteps
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops.envelope import envelope_errors
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.train import steps
from deepsc_gan_tpu_torch.utils import convert
from deepsc_gan_tpu_torch.utils.config import Config
from test_torch_attention import _inputs
from test_torch_model import flax_params, port_config

N_STD = 0.3


@pytest.mark.parametrize("shape", [(2, 48, 48, 2, 8), (2, 33, 64, 2, 8),
                                   (1, 70, 40, 2, 16), (1, 130, 130, 2, 8),
                                   (1, 31, 160, 1, 16), (1, 160, 31, 2, 32)])
def test_attention_plain_versions_match_jax_kernel_past_32(shape):
    """K1's and K2's plain versions against the interpreted TPU kernel and
    its VJP: the output, dq, dk, dv and dbias; past 32 and past 128
    queries or keys (where the bf16 K2 runs the cluster kernel on the
    card)."""
    b, lq, lk, h, dh = shape
    q, k, v, bias = _inputs(4, b, lq, lk, h, dh)
    g = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    scale = float(np.sqrt(dh))
    set_attn_kernel_mode("interpret")
    try:
        out, vjp = jax.vjp(lambda *a: jax_fused_attention(*a, h, scale),
                           *(jnp.asarray(x) for x in (q, k, v, bias)))
        want = [out, *vjp(jnp.asarray(g))]
    finally:
        set_attn_kernel_mode("auto")
    tq, tk, tv, tb, tg = (torch.from_numpy(x) for x in (q, k, v, bias, g))
    got = [attn.attention_fwd_reference(tq, tk, tv, tb, h, scale),
           *attn.attention_bwd_reference(tq, tk, tv, tb, tg, h, scale)]
    for name, a, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("fused", [True, False])
def test_teacher_forced_loss_at_seq_len_48_matches_jax(tiny_cfg, fused):
    """The vanilla encode -> channel -> decode -> masked CE at seq_len 48
    (the encoder's 48 x 48 attention, the decoder's 47 x 47 and 47 x 48),
    and its gradients, with the JAX channel's noise."""
    cfg = tiny_cfg.replace(seq_len=48, max_length=47, encoder_dropout=0.0,
                           decoder_dropout=0.0, fused_ce=fused)
    jmodel, params = flax_params(cfg, seed=7)
    rng = np.random.default_rng(8)
    inp = rng.integers(4, cfg.vocab_size, (cfg.bs, cfg.seq_len)).astype(
        np.int32)
    inp[:, 0] = cfg.start_idx
    for r, n in enumerate((48, 40, 33, 20)):
        inp[r, n - 1] = cfg.end_idx
        inp[r, n:] = cfg.pad_idx
    ji = jnp.asarray(inp)
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(
        key, (cfg.bs, cfg.seq_len, cfg.channel_dim), jnp.float32))
    masks = jax_create_masks(ji, ji[:, :-1], cfg.pad_idx)
    p0 = jnp.zeros((cfg.bs, cfg.seq_len, cfg.channel_dim))
    jloss = jsteps.make_forward_loss(jmodel, cfg, "AWGN",
                                     jsteps._loss_kwargs(cfg))
    want, grads = jax.value_and_grad(lambda p: jloss(
        p, ji, ji[:, :-1], ji[:, 1:], key, key, p0, 0.0, N_STD, *masks))(
        params)

    tcfg = port_config(cfg)
    model = convert.load_into(make_model(tcfg), params)
    t = torch.from_numpy(inp).long()
    tm = create_masks(t, t[:, :-1], cfg.pad_idx)
    got = steps.make_forward_loss(model, tcfg, steps._loss_kwargs(tcfg))(
        t, t[:, :-1], t[:, 1:], torch.tensor(noise), N_STD, *tm, None)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    back = convert.state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()}, tcfg)
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(g), atol=1e-5,
                                   err_msg=str(path))


@pytest.mark.parametrize("variant,mode", [("transformer", None),
                                          ("transformer", "teacher_forced"),
                                          ("transformer", "greedy"),
                                          ("gan", None),
                                          ("gan", "greedy_gan")])
def test_check_envelope_accepts_seq_len_48(variant, mode):
    cfg = Config(seq_len=48, max_length=47)
    assert envelope_errors(cfg, variant, mode, device="cuda") == []
