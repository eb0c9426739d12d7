"""The port's plain training path against the JAX package's on the CPU at
f32: three train steps from the same weights on the same batches with the
channel noise JAX draws (dropout off: flax's dropout bits cannot be
reproduced) give the same losses, step-1 gradients, params, Adam moments
and EMA shadow, tied and untied, with the constant and the noam schedule.
Also the schedules, the batch order, dropout, the gradient through the
power normalization, and `cli train`."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepsc_gan_tpu.data.loader import (
    synthetic_dataset as jax_synthetic_dataset,
)
from deepsc_gan_tpu.models.transceiver import make_model as make_flax_model
from deepsc_gan_tpu.ops.masks import create_masks as jax_create_masks
from deepsc_gan_tpu.ops.pallas.attention import set_attn_kernel_mode
from deepsc_gan_tpu.ops.pallas.ce import set_ce_kernel_mode
from deepsc_gan_tpu.ops.schedule import make_optimizer as jax_make_optimizer
from deepsc_gan_tpu.train import steps as jsteps
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_dataset
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops.layers import dropout
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.ops.schedule import make_optimizer
from deepsc_gan_tpu_torch.train import steps
from deepsc_gan_tpu_torch.utils import convert
from test_torch_greedy import TINY_FLAGS
from test_torch_model import flax_params, port_config

ATOL = 1e-5
N_STD = 0.3


@pytest.fixture
def interpret():
    set_attn_kernel_mode("interpret")
    set_ce_kernel_mode("interpret")
    try:
        yield
    finally:
        set_attn_kernel_mode("auto")
        set_ce_kernel_mode("auto")


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(got_named, want_tree, cfg, what):
    got = _leaves(convert.state_dict_to_flax(got_named, port_config(cfg)))
    want = _leaves(want_tree)
    assert sorted(got) == sorted(want), what
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=ATOL,
                                   err_msg=f"{what}: {name}")


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _batches(cfg, n):
    """The first n batches of the synthetic training set, drawn by both
    packages' Dataset from one seed: they must be equal."""
    jds = jax_synthetic_dataset(64, cfg.seq_len, cfg.vocab_size, cfg.bs,
                                seed=3)
    tds = synthetic_dataset(64, cfg.seq_len, cfg.vocab_size, cfg.bs, seed=3)
    jds.set_epoch(1)
    tds.set_epoch(1)
    out = []
    for (ji, jt), (ti, tt) in zip(jds, tds):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tt, jt)
        out.append(ji)
    assert len(out) == len(jds) == len(tds)
    return out[:n]


CASES = {
    "untied-constant": dict(tie_embeddings=False),
    "tied-constant": dict(tie_embeddings=True),
    "untied-noam": dict(tie_embeddings=False, schedule="noam",
                        warmup_steps=40),
    "tied-noam": dict(tie_embeddings=True, schedule="noam", warmup_steps=40),
    "tied-constant-ema": dict(tie_embeddings=True, ema_decay=0.9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_train_steps_match_jax(tiny_cfg, interpret, case):
    cfg = tiny_cfg.replace(encoder_dropout=0.0, decoder_dropout=0.0,
                           **CASES[case])
    jmodel, params = flax_params(cfg, seed=4)
    jstate = jsteps.create_train_state(jmodel, cfg, jax.random.PRNGKey(0))
    jstate = jstate.replace(
        params=params, opt_state=jstate.tx.init(params),
        ema_params=(jax.tree.map(jnp.copy, params) if cfg.ema_decay else
                    None))
    jstep = jsteps.make_train_step(jmodel, cfg)
    lkw = jsteps._loss_kwargs(cfg)
    jloss = jsteps.make_forward_loss(jmodel, cfg, "AWGN", lkw)

    tcfg = port_config(cfg)
    model = convert.load_into(make_model(tcfg), params).train()
    state = steps.create_train_state(model, tcfg)
    step = steps.make_train_step(model, tcfg)
    gen = torch.Generator().manual_seed(0)

    for i, inp in enumerate(_batches(cfg, 3)):
        key = jax.random.PRNGKey(100 + i)
        k_ch, k_do, _ = jax.random.split(key, 3)
        noise = np.asarray(jax.random.normal(
            k_ch, (cfg.bs, cfg.seq_len, cfg.channel_dim), jnp.float32))
        if i == 0:
            batch = jnp.asarray(inp)
            tar_inp, tar_real = batch[:, :-1], batch[:, 1:]
            masks = jax_create_masks(batch, tar_inp, cfg.pad_idx)
            p0 = jnp.zeros((cfg.bs, cfg.seq_len, cfg.channel_dim))
            grads = jax.grad(lambda p: jloss(
                p, batch, tar_inp, tar_real, k_ch, k_do, p0, 0.0, N_STD,
                *masks))(jstate.params)
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
    if cfg.ema_decay:
        _assert_trees_close(steps.eval_params(state), jstate.ema_params,
                            cfg, "ema")


@pytest.mark.parametrize("fused", [True, False])
def test_loss_paths_match_jax(tiny_cfg, tiny_batch, interpret, fused):
    """The forward loss with label smoothing and quirk Q2's extra ids, through
    the fused CE (hidden states) and through materialized logits."""
    cfg = tiny_cfg.replace(encoder_dropout=0.0, decoder_dropout=0.0,
                           fused_ce=fused, label_smoothing=0.1,
                           mask_extra_tokens=True)
    jmodel, params = flax_params(cfg, seed=5)
    inp = jnp.asarray(tiny_batch)
    tar_inp, tar_real = inp[:, :-1], inp[:, 1:]
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(
        key, (cfg.bs, cfg.seq_len, cfg.channel_dim), jnp.float32))
    masks = jax_create_masks(inp, tar_inp, cfg.pad_idx)
    p0 = jnp.zeros((cfg.bs, cfg.seq_len, cfg.channel_dim))
    want = jsteps.make_forward_loss(jmodel, cfg, "AWGN",
                                    jsteps._loss_kwargs(cfg))(
        params, inp, tar_inp, tar_real, key, key, p0, 0.0, N_STD, *masks)

    tcfg = port_config(cfg)
    model = convert.load_into(make_model(tcfg), params)
    t = torch.tensor(np.asarray(inp)).long()
    tm = create_masks(t, t[:, :-1], cfg.pad_idx)
    got = steps.make_forward_loss(model, tcfg, steps._loss_kwargs(tcfg))(
        t, t[:, :-1], t[:, 1:], torch.tensor(noise), N_STD, *tm, None)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("schedule", ["constant", "noam", "cosine"])
def test_schedules_match_optax(schedule):
    """The learning rate at every count, and Adam's hyper-parameters, as
    the JAX package's make_optimizer gives them: its update divided by the
    update of Adam at lr 1 with the same betas and eps, on the same
    gradients, is the schedule's value."""
    kw = dict(lr=5e-4, schedule=schedule, d_model=128, warmup_steps=40,
              decay_steps=400)
    opt, lr_fn = make_optimizer([torch.nn.Parameter(torch.zeros(1))], **kw)
    (b1, b2), eps = opt.param_groups[0]["betas"], opt.param_groups[0]["eps"]
    assert ((b1, b2), eps) == (((0.9, 0.98), 1e-9) if schedule == "noam"
                               else ((0.9, 0.999), 1e-8))
    jtx = jax_make_optimizer(**kw)
    unit = optax.adam(1.0, b1=b1, b2=b2, eps=eps)
    js, us = jtx.init(jnp.zeros(1)), unit.init(jnp.zeros(1))
    for count in range(450):
        g = jnp.full((1,), 1.0 + 0.01 * count)
        upd, js = jtx.update(g, js)
        ref, us = unit.update(g, us)
        np.testing.assert_allclose(lr_fn(count), float(upd[0] / ref[0]),
                                   rtol=1e-6, err_msg=f"count {count}")


def test_dropout_draws_from_the_generator_alone(tiny_cfg, tiny_batch):
    """Same generator seed -> the same loss; with a generator (train) the
    output differs from without (deterministic); the global RNG is not
    touched."""
    cfg = port_config(tiny_cfg.replace(encoder_dropout=0.1,
                                       decoder_dropout=0.1))
    model = steps.init_params(make_model(cfg), seed=1)
    t = torch.tensor(np.asarray(tiny_batch)).long()
    masks = create_masks(t, t[:, :-1], cfg.pad_idx)
    noise = torch.randn((cfg.bs, cfg.seq_len, cfg.channel_dim),
                        generator=torch.Generator().manual_seed(2))
    fl = steps.make_forward_loss(model, cfg, steps._loss_kwargs(cfg))

    def loss(gen):
        return fl(t, t[:, :-1], t[:, 1:], noise, N_STD, *masks, gen).item()

    state = torch.get_rng_state()
    a = loss(torch.Generator().manual_seed(9))
    b = loss(torch.Generator().manual_seed(9))
    c = loss(torch.Generator().manual_seed(10))
    assert torch.equal(state, torch.get_rng_state())
    assert a == b and a != c
    assert loss(None) != a and loss(None) == loss(None)


def test_dropout_keep_rate_and_scale():
    x = torch.ones((1000, 1000))
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.003
    assert torch.allclose(y[kept], torch.tensor(1.0 / 0.9))
    assert dropout(x, 0.1, None) is x and dropout(x, 0.0,
                                                  torch.Generator()) is x


def test_gradient_flows_through_power_normalization(tiny_cfg, tiny_batch):
    """d/d(channel encoder params) of mean(tx * r): tx is power-normalized
    over the whole batch, so every row's gradient depends on the norm."""
    cfg = tiny_cfg.replace(encoder_dropout=0.0)
    jmodel, params = flax_params(cfg, seed=6)
    inp = jnp.asarray(tiny_batch)
    enc_mask = jax_create_masks(inp, inp[:, :-1])[0]
    r = np.random.default_rng(7).standard_normal(
        (cfg.bs, cfg.seq_len, cfg.channel_dim)).astype(np.float32)
    want = jax.grad(lambda p: jnp.mean(jmodel.apply(
        {"params": p}, inp, enc_mask, method="encode") * r))(params)
    model = convert.load_into(make_model(port_config(cfg)), params)
    t = torch.tensor(np.asarray(inp)).long()
    (model.encode(t, create_masks(t, t[:, :-1])[0])
     * torch.from_numpy(r)).mean().backward()
    got = {n: p.grad for n, p in model.named_parameters()
           if n.startswith("channel_encoder")}
    enc = {"channel_encoder": want["channel_encoder"]}
    _assert_trees_close(got, enc, cfg, "channel encoder grads")


def test_cli_train_logs_and_saves_params_flax_loads(tmp_path, tiny_cfg):
    """`cli train --scan-steps 1` (one step a call) at tiny widths on the
    CPU for 2 epochs of a training pickle of 512 sentences (8 steps of 64
    an epoch): train.jsonl holds every 4th step's loss and sents_per_sec;
    the saved pickle loads into the flax model, whose logits equal the
    port's; training starts again from it with --params-pkl."""
    rows = synthetic_dataset(512, 12, 40, 64, seed=2).data
    with open(tmp_path / "train.pkl", "wb") as f:
        pickle.dump([row[row != 0].tolist() for row in rows], f)
    flags = ["train", "--device", "cpu", *TINY_FLAGS, "--epochs", "2",
             "--log-every", "4", "--tie-embeddings", "--scan-steps", "1",
             "--log-save-path", str(tmp_path / "log"),
             "--checkpoint-path", str(tmp_path / "ckpt"),
             "--train-save-path", str(tmp_path / "train.pkl")]
    res = cli.main(flags)
    assert res["steps"] == 2 * 512 // 64 and res["device"] == "cpu"
    assert res["path"] == "single"
    losses = res["losses"]
    assert losses.shape == (16,) and torch.isfinite(losses).all()
    recs = [json.loads(line)
            for line in (tmp_path / "log" / "train.jsonl").read_text()
            .splitlines()]
    logged = [r for r in recs if "loss" in r]
    assert [r["step"] for r in logged] == list(range(4, 17, 4))
    np.testing.assert_allclose([r["loss"] for r in logged],
                               losses[3::4].numpy(), rtol=1e-6)
    rates = [r for r in recs if "sents_per_sec" in r]
    assert [r["epoch"] for r in rates] == [0, 1]
    assert all(r["sents_per_sec"] > 0 for r in rates)

    with open(res["params_path"], "rb") as f:
        blob = pickle.load(f)
    assert blob["recipe"]["steps"] == 16
    assert blob["recipe"]["scan_steps"] == 1
    cfg = tiny_cfg.replace(tie_embeddings=True)
    params = jax.tree.map(jnp.asarray, blob["params"])
    inp = jnp.asarray(synthetic_dataset(8, cfg.seq_len, cfg.vocab_size, 8,
                                        seed=1).data)
    tar = inp[:, :-1]
    masks = jax_create_masks(inp, tar)
    key = jax.random.PRNGKey(0)
    p0 = jnp.zeros((8, cfg.seq_len, cfg.channel_dim))
    want, *_ = make_flax_model(cfg, "transformer").apply(
        {"params": params}, inp, tar, key, p0, 0.0, "AWGN", N_STD, *masks)
    noise = np.asarray(jax.random.normal(key, p0.shape, jnp.float32))
    model = convert.load_into(make_model(port_config(cfg)),
                              blob["params"]).eval()
    t = torch.tensor(np.asarray(inp)).long()
    tm = create_masks(t, t[:, :-1])
    with torch.no_grad():
        y = model.transmit(model.encode(t, tm[0]), torch.tensor(noise),
                           N_STD)
        got = model.decode(t[:, :-1], y, tm[1], tm[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    again = cli.main(flags[:flags.index("--epochs")] + [
        "--epochs", "1", "--log-every", "1000", "--scan-steps", "1",
        "--params-pkl", res["params_path"],
        "--train-save-path", str(tmp_path / "train.pkl"),
        "--log-save-path", str(tmp_path / "log2"),
        "--checkpoint-path", str(tmp_path / "ckpt2")])
    assert again["steps"] == 8 and torch.isfinite(again["losses"]).all()


def test_dense_reuses_its_cast_only_while_the_weights_are_unchanged():
    """Without autograd a bf16 Dense keeps its cast weights; an in-place
    update (an optimizer step, a load) makes it cast again; with autograd
    the gradient reaches the f32 weights."""
    from deepsc_gan_tpu_torch.ops.layers import Dense

    d = Dense(8, 4, dtype=torch.bfloat16)
    x = torch.randn(3, 8)

    def want():
        return torch.nn.functional.linear(x.bfloat16(), d.weight.bfloat16(),
                                          d.bias.bfloat16())

    with torch.inference_mode():
        a = d(x)
        cached = d._cast
        assert torch.equal(a, want()) and torch.equal(d(x), a)
        assert d._cast is cached
    with torch.no_grad():
        d.bias.add_(1.0)
    with torch.inference_mode():
        assert torch.equal(d(x), want()) and d._cast is not cached
    d(x).float().sum().backward()
    assert d.weight.grad.dtype == torch.float32


@pytest.mark.parametrize("mix", [1.0, 0.5, 0.0])
def test_step_noise_draws_the_snr_from_the_generator(tiny_cfg, mix):
    """train_snr_random: SNR ~ U(lo, hi) dB as 10^(-SNR/20), taken with
    probability train_snr_mix, else the fixed n_std; off, n_std as given."""
    cfg = port_config(tiny_cfg.replace(train_snr_random=True,
                                       train_snr_lo=2.0, train_snr_hi=10.0,
                                       train_snr_mix=mix))
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([torch.as_tensor(steps._step_noise(cfg, gen, 0.7,
                                                           "cpu"))
                         for _ in range(400)])
    fixed = draws == 0.7
    drawn = draws[~fixed]
    assert (drawn >= 10 ** (-10 / 20) - 1e-6).all()
    assert (drawn <= 10 ** (-2 / 20) + 1e-6).all()
    assert abs(fixed.float().mean().item() - (1.0 - mix)) < 0.08
    assert steps._step_noise(port_config(tiny_cfg), gen, 0.7, "cpu") == 0.7
