"""The port's multi-step training (`train/steps.py:make_train_multi_step`,
`data/loader.py:stacked_batches`, `cli train --scan-steps`) against the JAX
package's `make_train_multi_step` (K steps in one `lax.scan`) and its CLI
loop, on the CPU at f32, where the port runs K eager steps a call. The same
inputs and channel normals go to both sides (JAX's `split(key, K)`, then
`split(k, 3)[0]` per step); dropout 0. The JAX side takes its kernels' plain
references (the "auto" kernel modes on the CPU), as its own CPU tests do.
The captured CUDA graph of the step is held to the eager step on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.data import loader as jax_loader
from deepsc_gan_tpu.ops.schedule import make_optimizer as jax_make_optimizer
from deepsc_gan_tpu.train import steps as jsteps
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data import loader
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.train import steps
from deepsc_gan_tpu_torch.utils import convert
from test_torch_greedy import TINY_FLAGS
from test_torch_model import flax_params, port_config
from test_torch_star import star_params
from test_torch_train import N_STD, _adam_state, _assert_trees_close, _batches

K = 3
# name -> (variant, Config fields): an untied vanilla step, a tied one with
# the EMA shadow under noam (the rate changes every count), and the star
# codec scoring the un-shifted target (`full_target`)
CASES = {
    "vanilla": ("transformer", dict(tie_embeddings=False)),
    "ema_noam": ("transformer", dict(tie_embeddings=True, ema_decay=0.9,
                                     schedule="noam", warmup_steps=40)),
    "star_full_target": ("star", dict()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_multi_step_matches_jax(tiny_cfg, case):
    """K = 3 steps in one call of each package's multi-step: the losses (K,)
    within rtol 1e-5; the params, the Adam moments, the EMA shadow and the
    count within 1e-5."""
    variant, fields = CASES[case]
    star = variant == "star"
    cfg = tiny_cfg.replace(encoder_dropout=0.0, decoder_dropout=0.0,
                           **fields)
    jmodel, params = (star_params(cfg, 7, variant) if star
                      else flax_params(cfg, seed=4))
    tx = jax_make_optimizer(cfg.lr, cfg.schedule, cfg.encoder_d_model,
                            cfg.warmup_steps, cfg.decay_steps)
    jstate = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), tx=tx,
        ema_params=jax.tree.map(jnp.copy, params) if cfg.ema_decay else None,
        ema_decay=cfg.ema_decay)
    inps = np.stack(_batches(cfg, K))
    key = jax.random.PRNGKey(300)
    jmulti = jsteps.make_train_multi_step(jmodel, cfg, full_target=star,
                                          donate=False)
    jstate, want = jmulti(jstate, jnp.asarray(inps), jnp.asarray(inps), key,
                          N_STD)
    shape = (cfg.bs, cfg.seq_len, cfg.channel_dim)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.split(k, 3)[0], shape, jnp.float32))
        for k in jax.random.split(key, K)])

    tcfg = port_config(cfg)
    model = convert.load_into(make_model(tcfg, variant), params).train()
    state = steps.create_train_state(model, tcfg)
    multi = steps.make_train_multi_step(model, tcfg, full_target=star)
    t = torch.from_numpy(inps).long()
    state, got = multi(state, t, t, torch.Generator().manual_seed(0), N_STD,
                       noise=torch.from_numpy(noise))
    assert got.shape == (K,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert state.step == int(jstate.step) == K
    named = dict(model.named_parameters())
    _assert_trees_close(named, jstate.params, cfg, "params")
    adam = _adam_state(jstate.opt_state)
    for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        _assert_trees_close(
            {n: state.optimizer.state[p][name] for n, p in named.items()},
            tree, cfg, name)
    if cfg.ema_decay:
        _assert_trees_close(steps.eval_params(state), jstate.ema_params,
                            cfg, "ema")


def test_stacked_batches_match_jax_across_epoch_boundaries():
    """(k, B, L) stacks of 3 batches over a set of 16 batches (16 % 3 =
    1): the JAX package's stacks, in order, over three passes of the set,
    with and without the CLI's set_epoch between passes."""
    data = loader.synthetic_sentences(64, 12, 40, seed=5, max_len=12)
    for reseed in (False, True):
        tds = loader.Dataset(data, batch_size=4, seed=2)
        jds = jax_loader.Dataset(data, batch_size=4, seed=2)
        got, want = (loader.stacked_batches(tds, 3),
                     jax_loader.stacked_batches(jds, 3))
        for i in range(16):  # 48 batches: three passes
            if reseed and i % 5 == 0:
                tds.set_epoch(i)
                jds.set_epoch(i)
            a, b = next(got), next(want)
            assert a.shape == (3, 4, 12)
            np.testing.assert_array_equal(a, b)


def _jax_loop_schedule(n_batches, k, epochs, log_every):
    """The JAX CLI's scan loop (deepsc_gan_tpu/cli.py, `stacker`): -> (the
    steps taken, the steps it logs a loss at)."""
    step_i, logged = 0, []
    for _ in range(epochs):
        for _ in range(max(1, n_batches // k)):
            step_i += k
            if (step_i // k) % log_every == 0:
                logged.append(step_i)
    return step_i, logged


def test_cli_train_scan_steps_logs_and_counts_as_the_jax_loop(tmp_path,
                                                              monkeypatch):
    """`cli train --scan-steps 4` on a pickle of 11 batches (11 % 4 = 3)
    for 2 epochs: path scan4, len(ds) // 4 * 4 = 8 steps an epoch, a loss
    logged at the steps the JAX loop logs at (the call's last loss), the
    stacks those of the JAX package's stacker driven as its CLI drives it
    (set_epoch every epoch, stacks running on across the boundary), and the
    recipe records scan_steps."""
    rows = loader.synthetic_sentences(11 * 8, 12, 40, seed=6, max_len=12)
    with open(tmp_path / "train.pkl", "wb") as f:
        pickle.dump([row[row != 0].tolist() for row in rows], f)
    seen = []
    real = cli.stacked_batches

    def recorded(ds, k):
        for stack in real(ds, k):
            seen.append(stack)
            yield stack

    monkeypatch.setattr(cli, "stacked_batches", recorded)
    res = cli.main(["train", "--device", "cpu", *TINY_FLAGS, "--bs", "8",
                    "--epochs", "2", "--scan-steps", "4", "--log-every", "2",
                    "--seed", "3", "--log-save-path", str(tmp_path / "log"),
                    "--checkpoint-path", str(tmp_path / "ckpt"),
                    "--train-save-path", str(tmp_path / "train.pkl")])
    steps_taken, logged = _jax_loop_schedule(11, 4, 2, 2)
    assert (res["path"], res["steps"]) == ("scan4", steps_taken) == \
        ("scan4", 16)
    losses = res["losses"]
    assert losses.shape == (16,) and torch.isfinite(losses).all()
    recs = [json.loads(line) for line in
            (tmp_path / "log" / "train.jsonl").read_text().splitlines()]
    got = [r for r in recs if "loss" in r]
    assert [r["step"] for r in got] == logged == [8, 16]
    np.testing.assert_allclose([r["loss"] for r in got],
                               [losses[s - 1].item() for s in logged],
                               rtol=1e-6)
    assert [r["epoch"] for r in recs if "sents_per_sec" in r] == [0, 1]

    jds = jax_loader.Dataset(loader.load_sentences(
        str(tmp_path / "train.pkl"), 12, 40), batch_size=8, seed=3)
    stacker = jax_loader.stacked_batches(jds, 4)
    want = []
    for epoch in range(2):
        jds.set_epoch(epoch)
        want += [next(stacker) for _ in range(max(1, len(jds) // 4))]
    assert len(seen) == len(want) == 4
    for a, b in zip(seen, want):
        np.testing.assert_array_equal(a, b)
    with open(res["params_path"], "rb") as f:
        recipe = pickle.load(f)["recipe"]
    assert (recipe["scan_steps"], recipe["steps"]) == (4, 16)


def test_set_lr_writes_a_float_rate_and_fills_a_tensor_rate():
    """The CPU's Adam holds its rate as a float, which `set_lr` replaces;
    a rate held as a tensor (the card's capturable Adam) is filled in
    place, so a captured update reads the new rate from the same memory."""
    from deepsc_gan_tpu_torch.ops.schedule import make_optimizer, set_lr

    params = [torch.nn.Parameter(torch.zeros(3))]
    opt, lr_fn = make_optimizer(params, schedule="noam", d_model=16,
                                warmup_steps=4)
    assert opt.param_groups[0]["lr"] == lr_fn(0)
    set_lr(opt, lr_fn(3))
    assert opt.param_groups[0]["lr"] == lr_fn(3)
    rate = torch.zeros(())
    opt.param_groups[0]["lr"] = rate
    set_lr(opt, lr_fn(2))
    assert opt.param_groups[0]["lr"] is rate
    assert rate.item() == np.float32(lr_fn(2))
