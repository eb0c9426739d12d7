"""The port's star training path against the JAX package's on the CPU at
f32: three `full_target` train steps from the same weights on the same
batches with the channel noise JAX draws (dropout off) give the same
losses, step-1 gradients, params and Adam moments as
`make_train_step(full_target=True)`, the JAX CE through its interpreted
Pallas kernels and the port's through its plain versions. Also the tied
star decoders' vocab projection in the fused CE, `cli train --variant
star` and `cli evaluate` of what it saved."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.models.transceiver import make_model as make_flax_model
from deepsc_gan_tpu.ops.masks import create_masks as jax_create_masks
from deepsc_gan_tpu.ops.pallas.ce import set_ce_kernel_mode
from deepsc_gan_tpu.ops.schedule import make_optimizer as jax_make_optimizer
from deepsc_gan_tpu.train import steps as jsteps
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_sentences
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.train import steps
from deepsc_gan_tpu_torch.utils import convert
from test_torch_model import port_config
from test_torch_star import star_params
from test_torch_star_serve import STAR_FLAGS
from test_torch_train import (
    N_STD,
    _adam_state,
    _assert_trees_close,
    _batches,
)


@pytest.fixture
def interpret_ce():
    set_ce_kernel_mode("interpret")
    try:
        yield
    finally:
        set_ce_kernel_mode("auto")


def test_three_star_train_steps_match_jax(tiny_cfg, interpret_ce):
    cfg = tiny_cfg.replace(encoder_dropout=0.0, decoder_dropout=0.0)
    jmodel, params = star_params(cfg, 7, "star")
    tx = jax_make_optimizer(cfg.lr, cfg.schedule, cfg.encoder_d_model,
                            cfg.warmup_steps, cfg.decay_steps)
    jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=tx.init(params), tx=tx,
                               ema_params=None, ema_decay=0.0)
    jstep = jsteps.make_train_step(jmodel, cfg, full_target=True)
    jloss = jsteps.make_forward_loss(jmodel, cfg, "AWGN",
                                     jsteps._loss_kwargs(cfg))

    tcfg = port_config(cfg)
    model = convert.load_into(make_model(tcfg, "star"), params).train()
    state = steps.create_train_state(model, tcfg)
    step = steps.make_train_step(model, tcfg, full_target=True)
    gen = torch.Generator().manual_seed(0)

    for i, inp in enumerate(_batches(cfg, 3)):
        key = jax.random.PRNGKey(200 + i)
        k_ch, k_do, _ = jax.random.split(key, 3)
        noise = np.asarray(jax.random.normal(
            k_ch, (cfg.bs, cfg.seq_len, cfg.channel_dim), jnp.float32))
        if i == 0:
            batch = jnp.asarray(inp)
            masks = jax_create_masks(batch, batch[:, :-1], cfg.pad_idx)
            p0 = jnp.zeros((cfg.bs, cfg.seq_len, cfg.channel_dim))
            grads = jax.jit(jax.grad(lambda p: jloss(
                p, batch, batch[:, :-1], batch, k_ch, k_do, p0, 0.0, N_STD,
                *masks)))(jstate.params)
        jstate, want = jstep(jstate, jnp.asarray(inp), jnp.asarray(inp), key,
                             N_STD)
        t = torch.from_numpy(inp).long()
        state, got = step(state, t, t, gen, N_STD,
                          noise=torch.tensor(noise))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   err_msg=f"loss at step {i + 1}")
        if i == 0:
            _assert_trees_close(
                {n: p.grad for n, p in model.named_parameters()}, grads, cfg,
                "step-1 grads")

    assert state.step == int(jstate.step) == 3
    _assert_trees_close(dict(model.named_parameters()), jstate.params, cfg,
                        "params")
    adam = _adam_state(jstate.opt_state)
    named = dict(model.named_parameters())
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        _assert_trees_close(
            {n: state.optimizer.state[p][key] for n, p in named.items()},
            tree, cfg, key)


@pytest.mark.parametrize("variant", ["star", "star_multi"])
def test_tied_star_loss_projects_with_the_decoder_table(tiny_cfg, variant):
    """A tied star decoder's fused CE (`_final_wb`: its embedding table and
    final bias) gives the loss and gradients of its materialized logits."""
    cfg = port_config(tiny_cfg.replace(tie_embeddings=True,
                                       label_smoothing=0.1))
    model = steps.init_params(make_model(cfg, variant), seed=3)
    rng = np.random.default_rng(4)
    inp = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                        (cfg.bs, cfg.seq_len))).long()
    inp[:, -3:] = 0
    masks = create_masks(inp, inp[:, :-1], cfg.pad_idx)
    noise = torch.from_numpy(rng.standard_normal(
        (cfg.bs, cfg.seq_len, cfg.channel_dim)).astype(np.float32))
    out = []
    for fused in (True, False):
        c = cfg.replace(fused_ce=fused)
        model.zero_grad()
        loss = steps.make_forward_loss(model, c, steps._loss_kwargs(c))(
            inp, inp[:, :-1], inp, noise, N_STD, *masks, None)
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}))
    (fused_loss, fused_grads), (loss, grads) = out
    np.testing.assert_allclose(fused_loss, loss, rtol=1e-6)
    assert fused_grads["semantic_decoder.embed.embedding.weight"].abs() \
        .sum() > 0
    for name, g in grads.items():
        torch.testing.assert_close(fused_grads[name], g, atol=1e-6,
                                   rtol=1e-5, msg=name)


def test_cli_star_train_then_evaluate(tiny_cfg, tmp_path, capsys):
    """`train --variant star` saves a pickle that the flax star model takes
    (the same tree as flax's init) and that `evaluate --variant star` loads
    without --params-pkl."""
    dirs = ["--checkpoint-path", str(tmp_path / "ckpt"),
            "--log-save-path", str(tmp_path / "log")]
    train_set = tmp_path / "train.pkl"
    with open(train_set, "wb") as f:
        pickle.dump([list(map(int, row)) for row in
                     synthetic_sentences(256, 12, 40, seed=1, max_len=12)], f)
    res = cli.main(["train", "--variant", "star", "--device", "cpu",
                    "--epochs", "1", "--bs", "64", "--log-every", "100",
                    "--scan-steps", "1",
                    "--train-save-path", str(train_set), *dirs,
                    *STAR_FLAGS])
    assert res["params_path"] == str(tmp_path / "ckpt" / "star_params.pkl")
    assert res["steps"] == 256 // 64
    assert torch.isfinite(res["losses"]).all()
    saved = convert.load_params_pickle(res["params_path"])
    key = jax.random.PRNGKey(0)
    init = jax.eval_shape(lambda: make_flax_model(tiny_cfg, "star").init(
        {"params": key}, jnp.zeros((1, 12), jnp.int32),
        jnp.zeros((1, 11), jnp.int32), key, jnp.zeros((1, 12, 8)), 0.0))
    assert jax.tree.map(np.shape, saved) == \
        jax.tree.map(lambda a: a.shape, init["params"])
    capsys.readouterr()
    out = cli.main(["evaluate", "--variant", "star", "--device", "cpu",
                    "--bs", "4", "--eval-batches", "1", "--snr-lo", "9",
                    "--snr-hi", "9", *dirs, *STAR_FLAGS])
    assert out["params_path"] == res["params_path"]
    assert f"params from {res['params_path']}" in capsys.readouterr().err
