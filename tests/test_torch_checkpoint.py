"""Epoch checkpoints and exact resume (`utils/checkpoint.py`, `cli train
--resume --ckpt-every`, `cli evaluate` restoring the latest checkpoint),
and the Adam-state bridge to the JAX package (`utils/convert.py`), on the
CPU at tiny widths: a save/restore round trip with and without the EMA
shadow and the JAX package's EMA-mismatch rules; keep-5; two epochs plus
`--resume` for two more bitwise equal to four straight epochs (params,
moments, counts, EMA, the generator's state), one step a call and four;
the `--resume` refusals; one step from a JAX mid-training state converted
into the port against the JAX step."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.train import steps as jsteps
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_dataset
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.train import steps
from deepsc_gan_tpu_torch.utils import convert
from deepsc_gan_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    load_params,
    save_params,
)
from test_torch_greedy import TINY_FLAGS
from test_torch_model import flax_params, port_config
from test_torch_train import (
    N_STD,
    _adam_state,
    _assert_trees_close,
    _batches,
)


def _trained_state(tiny_cfg, ema, seed=1, n=2):
    """A port TrainState after `n` steps (dropout on), and its config."""
    cfg = port_config(tiny_cfg, ema_decay=0.9 if ema else 0.0)
    model = steps.init_params(make_model(cfg), seed).train()
    state = steps.create_train_state(model, cfg)
    step = steps.make_train_step(model, cfg)
    gen = torch.Generator().manual_seed(seed)
    for inp in _batches(tiny_cfg, n):
        t = torch.from_numpy(inp).long()
        state, _ = step(state, t, t, gen, N_STD)
    return cfg, state


def _fresh_state(cfg, seed=5):
    model = steps.init_params(make_model(cfg), seed).train()
    return steps.create_train_state(model, cfg)


def _same_state(a, b):
    """Params, Adam moments and counts, the update count and the EMA
    shadow bitwise equal."""
    assert a.step == b.step
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], sb[key]), (name, key)
    assert (a.ema is None) == (b.ema is None)
    if a.ema is not None:
        assert all(torch.equal(a.ema[n], b.ema[n]) for n in a.ema)


@pytest.mark.parametrize("ema", [False, True])
def test_save_restore_round_trip(tiny_cfg, tmp_path, ema):
    cfg, state = _trained_state(tiny_cfg, ema)
    mgr = CheckpointManager(str(tmp_path / "transformer"))
    extra = {"generator": torch.Generator().manual_seed(4).get_state()}
    mgr.save(2, state, extra)
    restored = mgr.restore(_fresh_state(cfg))
    _same_state(restored, state)
    assert torch.equal(mgr.extra()["generator"], extra["generator"])
    assert mgr.latest_epoch() == 2 and mgr.epochs() == [2]
    assert os.path.exists(tmp_path / "transformer" / "2" / "state.pt")
    # evaluation takes the EMA shadow when saved
    want = state.ema if ema else dict(state.model.named_parameters())
    got = mgr.eval_params()
    assert all(torch.equal(got[n], want[n]) for n in want)
    mgr.close()


def test_restore_follows_the_ema_mismatch_rules(tiny_cfg, tmp_path):
    """A run with EMA restoring a checkpoint without one re-seeds the
    shadow from the restored params; a run without EMA ignores a saved
    shadow (the JAX package's rules)."""
    cfg, plain = _trained_state(tiny_cfg, ema=False)
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(1, plain)
    with_ema = mgr.restore(_fresh_state(cfg.replace(ema_decay=0.9)))
    named = dict(with_ema.model.named_parameters())
    assert all(torch.equal(with_ema.ema[n], named[n]) for n in named)
    assert with_ema.ema[next(iter(named))] is not named[next(iter(named))]

    cfg, shadowed = _trained_state(tiny_cfg, ema=True)
    mgr = CheckpointManager(str(tmp_path / "b"))
    mgr.save(1, shadowed)
    no_ema = mgr.restore(_fresh_state(cfg.replace(ema_decay=0.0)))
    assert no_ema.ema is None
    assert all(torch.equal(p, q) for p, q in zip(
        no_ema.model.parameters(), shadowed.model.parameters()))
    with pytest.raises(ValueError, match="do not match"):
        mgr.restore(_fresh_state(cfg.replace(tie_embeddings=True)))


def test_keeps_the_newest_five(tiny_cfg, tmp_path):
    cfg, state = _trained_state(tiny_cfg, ema=False, n=1)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=5)
    for epoch in range(1, 9):
        mgr.save(epoch, state)
    assert mgr.epochs() == [4, 5, 6, 7, 8] and mgr.latest_epoch() == 8
    assert sorted(os.listdir(tmp_path / "ck")) == ["4", "5", "6", "7", "8"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_save_and_load_params(tmp_path, tiny_cfg):
    cfg, state = _trained_state(tiny_cfg, ema=False, n=1)
    named = {n: p.detach() for n, p in state.model.named_parameters()}
    path = str(tmp_path / "p" / "params.pt")
    save_params(path, named)
    got = load_params(path)
    assert all(torch.equal(got[n], named[n]) for n in named)
    template = {n: torch.zeros_like(p, dtype=torch.float64)
                for n, p in named.items()}
    cast = load_params(path, template)
    assert all(cast[n].dtype == torch.float64 for n in cast)
    with pytest.raises(ValueError):
        load_params(path, {"x": torch.zeros(1)})


def _corpus(tmp_path, n=64):
    """64 sentences: 8 batches of 8 an epoch (4 divides them)."""
    rows = synthetic_dataset(n, 12, 40, 8, seed=6).data
    path = tmp_path / "train.pkl"
    with open(path, "wb") as f:
        pickle.dump([row[row != 0].tolist() for row in rows], f)
    return str(path)


def _payload(ckpt, epoch):
    return torch.load(os.path.join(ckpt, "transformer", str(epoch),
                                   "state.pt"), weights_only=True)


def _assert_payloads_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            assert a[key].keys() == b[key].keys(), key
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name]), (key, name)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_resume_is_bitwise_the_straight_run(tmp_path, scan_steps):
    """Four straight epochs against two, then `--resume` for two more
    (dropout on, the EMA shadow, augmentation on): the epoch-4
    checkpoints hold the same params, Adam moments and counts, update
    count, EMA shadow and generator state, bit for bit; the final params
    pickles too. With --scan-steps 4 the 4-stacks run on across epoch
    boundaries and 4 divides the 8 batches of an epoch."""
    corpus = _corpus(tmp_path)

    def run(ckpt, extra):
        return cli.main(["train", "--device", "cpu", *TINY_FLAGS, "--bs",
                         "8", "--scan-steps", str(scan_steps),
                         "--ema-decay", "0.9", "--aug-crop", "0.3",
                         "--aug-synth", "0.2", "--ckpt-every", "2",
                         "--log-every", "1000", "--train-save-path", corpus,
                         "--log-save-path", str(tmp_path / "log"),
                         "--checkpoint-path", ckpt, *extra])

    straight, split = str(tmp_path / "a"), str(tmp_path / "b")
    res = run(straight, ["--epochs", "4"])
    assert res["steps"] == 32 and res["start_epoch"] == 0
    run(split, ["--epochs", "2"])
    res = run(split, ["--epochs", "4", "--resume"])
    assert res["start_epoch"] == 2 and res["steps"] == 16
    assert res["path"] == ("single" if scan_steps == 1 else "scan4")
    want, got = _payload(straight, 4), _payload(split, 4)
    assert got["step"] == 32 and "ema" in got
    _assert_payloads_equal(got, want)
    _assert_payloads_equal(_payload(split, 2), _payload(straight, 2))
    blobs = []
    for ckpt in (straight, split):
        with open(os.path.join(ckpt, "transformer_params.pkl"), "rb") as f:
            blobs.append(pickle.load(f)["params"])
    flat = [convert._flatten(b) for b in blobs]
    assert all(np.array_equal(flat[0][k], flat[1][k]) for k in flat[0])

    # nothing left to train, and no checkpoint at all
    with pytest.raises(SystemExit, match="nothing left to train"):
        run(split, ["--epochs", "4", "--resume"])
    with pytest.raises(SystemExit, match="no checkpoint under"):
        run(str(tmp_path / "none"), ["--epochs", "4", "--resume"])


@pytest.mark.parametrize("scan_steps", [3, 4])
def test_resume_says_when_it_is_not_bitwise(tmp_path, capsys, scan_steps):
    """`--resume` with K steps a call says at the start that the run will
    not be bit-identical when K does not divide the epoch's 8 batches,
    and says nothing when it does."""
    corpus, ckpt = _corpus(tmp_path), str(tmp_path / "ckpt")
    for extra in (["--epochs", "1"], ["--epochs", "2", "--resume"]):
        cli.main(["train", "--device", "cpu", *TINY_FLAGS, "--bs", "8",
                  "--scan-steps", str(scan_steps), "--log-every", "1000",
                  "--train-save-path", corpus, "--log-save-path",
                  str(tmp_path / "log"), "--checkpoint-path", ckpt, *extra])
    err = capsys.readouterr().err
    notice = (f"--resume: not bit-identical to a run not stopped: "
              f"--scan-steps {scan_steps} does not divide the epoch's 8 "
              f"batches")
    assert (notice in err) == (8 % scan_steps != 0)


def test_adam_bridge_continues_a_jax_run(tiny_cfg):
    """Two JAX steps, then the JAX state (params, optax's Adam moments and
    count) converted into the port; one more step of each from there: the
    losses within rtol 1e-5, the params, moments and count within 1e-5,
    and the port's moments read back as flax trees (`adam_state_to_flax`)
    equal to the JAX step's within 1e-5."""
    cfg = tiny_cfg.replace(encoder_dropout=0.0, decoder_dropout=0.0,
                           schedule="noam", warmup_steps=40)
    jmodel, params = flax_params(cfg, seed=4)
    jstate = jsteps.create_train_state(jmodel, cfg, jax.random.PRNGKey(0))
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    jstep = jsteps.make_train_step(jmodel, cfg)
    batches = _batches(cfg, 3)
    for i, inp in enumerate(batches[:2]):
        jstate, _ = jstep(jstate, jnp.asarray(inp), jnp.asarray(inp),
                          jax.random.PRNGKey(30 + i), N_STD)

    tcfg = port_config(cfg)
    model = convert.load_into(make_model(tcfg), jstate.params).train()
    state = steps.create_train_state(model, tcfg)
    adam = _adam_state(jstate.opt_state)
    named = dict(model.named_parameters())
    convert.load_flax_adam_state(state.optimizer, named, adam.mu, adam.nu,
                                 adam.count)
    state.step = int(jstate.step)
    assert state.step == 2

    key = jax.random.PRNGKey(50)
    k_ch = jax.random.split(key, 3)[0]
    noise = np.asarray(jax.random.normal(
        k_ch, (cfg.bs, cfg.seq_len, cfg.channel_dim), jnp.float32))
    jstate, want = jstep(jstate, jnp.asarray(batches[2]),
                         jnp.asarray(batches[2]), key, N_STD)
    t = torch.from_numpy(batches[2]).long()
    state, got = steps.make_train_step(model, tcfg)(
        state, t, t, torch.Generator().manual_seed(0), N_STD,
        noise=torch.tensor(noise))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    _assert_trees_close(named, jstate.params, cfg, "params")
    adam = _adam_state(jstate.opt_state)
    back = convert.adam_state_to_flax(state.optimizer, named, tcfg)
    assert back["count"] == int(adam.count) == 3
    _assert_trees_close(
        {n: state.optimizer.state[p]["exp_avg"] for n, p in named.items()},
        adam.mu, cfg, "exp_avg")
    for key_, tree in (("mu", adam.mu), ("nu", adam.nu)):
        want_leaves = jax.tree_util.tree_leaves(tree)
        got_leaves = jax.tree_util.tree_leaves(back[key_])
        assert len(want_leaves) == len(got_leaves)
        assert jax.tree_util.tree_structure(
            jax.tree.map(np.asarray, tree)) == \
            jax.tree_util.tree_structure(back[key_])
        for a, b in zip(got_leaves, want_leaves):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_evaluate_restores_the_latest_checkpoint(tmp_path):
    """`cli evaluate` with neither --params-pkl nor the trained pickle
    restores the latest epoch checkpoint, its EMA shadow: the same table
    as evaluating the pickle `train` saved (the EMA shadow too)."""
    ckpt = str(tmp_path / "ck")
    cli.main(["train", "--device", "cpu", *TINY_FLAGS, "--bs", "8",
              "--epochs", "2", "--ckpt-every", "1", "--ema-decay", "0.5",
              "--tie-embeddings", "--scan-steps", "1",
              "--train-save-path", _corpus(tmp_path),
              "--log-save-path", str(tmp_path / "log"),
              "--checkpoint-path", ckpt])

    def evaluate():
        return cli.main(["evaluate", "--device", "cpu", *TINY_FLAGS, "--bs",
                         "8", "--eval-batches", "1", "--snr-lo", "0",
                         "--snr-hi", "3", "--checkpoint-path", ckpt,
                         "--log-save-path", str(tmp_path / "log")])

    from_pickle = evaluate()
    assert from_pickle["params_path"].endswith("transformer_params.pkl")
    os.remove(os.path.join(ckpt, "transformer_params.pkl"))
    restored = evaluate()
    assert restored["params_path"] == os.path.join(ckpt, "transformer", "2")
    assert restored["table"] == from_pickle["table"]
