"""The port's MINE (`models/mine.py`, `train/mine_steps.py`, `cli train
--train-mode mine`) against the JAX package's on the CPU at f32, with the
same weights through the weight bridge: T's forward and the DV bound, the
marginal pairing on an explicit permutation, the gradient clip against
optax's, and three MINE steps from the same transceiver and T with JAX's
channel normals and permutations (dropout 0: flax's dropout bits cannot be
reproduced); then the CLI's mine mode and its refusal of every variant the
JAX step fails on."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepsc_gan_tpu.models import mine as jmine
from deepsc_gan_tpu.ops.masks import create_masks as jax_create_masks
from deepsc_gan_tpu.train import mine_steps as jmine_steps
from deepsc_gan_tpu.train import steps as jsteps
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_dataset
from deepsc_gan_tpu_torch.models.mine import (
    MINE,
    mine_loss,
    mutual_information,
    sample_batch,
)
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.train import mine_steps, steps
from deepsc_gan_tpu_torch.utils import convert
from test_torch_greedy import TINY_FLAGS
from test_torch_model import flax_params, port_config
from test_torch_train import N_STD, _adam_state, _batches, _leaves


def _jax_mine(cfg, seed):
    """(flax MINE, its MineState, the port's T holding its params, the
    port's MineState)."""
    mine, state = jmine_steps.create_mine_state(cfg, jax.random.PRNGKey(seed))
    port, port_state = mine_steps.create_mine_state(port_config(cfg))
    assert isinstance(port, MINE)
    port.load_state_dict(convert.flax_to_state_dict(state.params))
    return mine, state, port, port_state


def _symbols(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.bs, cfg.seq_len, cfg.channel_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def assert_close_to_largest(got_named, want_tree, cfg, what, tol=1e-5,
                            over_all=False):
    """Every leaf of the port's `got_named` (a state_dict) within `tol`
    times the largest |value| of the JAX leaf it pairs with (`over_all`:
    of every JAX leaf)."""
    got = _leaves(convert.state_dict_to_flax(got_named, port_config(cfg)))
    want = _leaves(want_tree)
    assert sorted(got) == sorted(want), what
    largest = max(float(np.abs(w).max()) for w in want.values())
    for name in want:
        scale = largest if over_all else float(np.abs(want[name]).max())
        err = float(np.abs(got[name] - want[name]).max())
        assert err <= tol * max(scale, 1e-30), \
            f"{what}: {name} {err} > {tol} x {scale}"


def test_mine_forward_and_bound_match_jax(tiny_cfg):
    """T on the joint and the marginal pairs, and the DV bound, with
    JAX's permutation (rtol 1e-5); the weight bridge both ways."""
    mine, state, port, _ = _jax_mine(tiny_cfg, 3)
    x, y = _symbols(tiny_cfg, 4)
    key = jax.random.PRNGKey(5)
    perm = np.array(jax.random.permutation(key, tiny_cfg.bs))
    v = {"params": state.params}
    want_t = np.asarray(mine.apply(v, x, y))
    want_loss, want_mi = jmine.mine_loss(v, mine, key, x, y)
    with torch.no_grad():
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        got_t = port(tx, ty)
        loss, mi = mine_loss(port, tx, ty, torch.from_numpy(perm))
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mi.item(), float(want_mi), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    back = _leaves(convert.state_dict_to_flax(port.state_dict(),
                                              port_config(tiny_cfg)))
    for name, leaf in _leaves(state.params).items():
        np.testing.assert_array_equal(back[name], leaf, err_msg=name)


def test_sample_batch_pairs_x_with_permuted_y():
    x = torch.arange(12.0).reshape(4, 3)
    y = 10 * x
    perm = torch.tensor([2, 0, 3, 1])
    xm, ym = sample_batch(x, y, perm)
    assert xm is x
    assert torch.equal(ym, torch.stack([y[2], y[0], y[3], y[1]]))
    t = torch.tensor([1.0, 2.0, 3.0, 4.0])
    want = t.mean() - (torch.logsumexp(t, 0) - np.log(4))
    assert torch.allclose(mutual_information(t, t), want)


@pytest.mark.parametrize("scale", [0.01, 0.3, 5.0, 300.0])
def test_clip_matches_optax(scale):
    """clip_by_global_norm_ against optax's clip_by_global_norm(1.0) at
    global norms below and above 1."""
    rng = np.random.default_rng(int(scale * 100))
    grads = [scale * rng.standard_normal(s).astype(np.float32)
             for s in ((5, 3), (7,), (2, 2, 2))]
    clip = optax.clip_by_global_norm(1.0)
    want, _ = clip.update([jnp.asarray(g) for g in grads],
                          clip.init(grads))
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = mine_steps.clip_by_global_norm_(params)
    np.testing.assert_allclose(norm.item(), np.sqrt(sum(
        (g.astype(np.float64) ** 2).sum() for g in grads)), rtol=1e-5)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-12)
    if scale < 0.1:  # below the norm: untouched
        assert all(np.array_equal(p.grad.numpy(), g)
                   for p, g in zip(params, grads))


def _jax_mine_grads(jmodel, mine, cfg, params, mine_params, inp, key):
    """JAX's gradient of -mi with respect to T's params as its step's T
    update forms it (on the transceiver `params`, the step's channel key,
    dropout key and permutation key), clipped by optax's
    clip_by_global_norm(1.0)."""
    inp = jnp.asarray(inp)
    tar_inp = inp[:, :-1]
    k_ch, k_do, k_perm = jax.random.split(key, 3)
    p0 = jnp.zeros((cfg.bs, cfg.seq_len, cfg.channel_dim), jnp.float32)
    _, tx, y, _ = jmodel.apply(
        {"params": params}, inp, tar_inp, k_ch, p0, 0.0, cfg.channel, N_STD,
        *jax_create_masks(inp, tar_inp, cfg.pad_idx), deterministic=False,
        rngs={"dropout": k_do})
    grads = jax.grad(lambda mp: jmine.mine_loss(
        {"params": mp}, mine, k_perm, tx, y)[0])(mine_params)
    clip = optax.clip_by_global_norm(1.0)
    return clip.update(grads, clip.init(grads))[0]


def test_three_mine_steps_match_jax(tiny_cfg):
    """Three MINE steps of each package from the same transceiver and T,
    with JAX's channel normals and permutations: ce and mi within rtol
    1e-5 at every step; after them the transceiver's params and Adam
    moments within 1e-5 of their largest value, both counts 3.

    T is held to JAX step by step: before each step the port's T and its
    Adam state are set to JAX's (the weight and Adam-state bridges), and
    the step's clipped T gradient must equal JAX's within 1e-5 of the
    largest element of T's gradient; T's update is then optax's
    adam(1e-3) on that gradient: its moments within 1e-6 of each tensor's
    largest, its params within 1e-5 of T's largest (torch's Adam takes its
    bias corrections in double, optax's in f32, where 1 - 0.999 is 4.7e-5
    off: an update differs by up to 2.3e-5 of itself, and a bias that
    starts at 0 is its first update).
    T's parameters are not compared after several steps: the DV bound is
    invariant under a constant shift of T, so the gradient with respect to
    fc2's bias (1 - sum softmax) and to the bias of a fc1 unit that every
    sample activates is zero in exact arithmetic, and each package leaves
    its own rounding (~1e-8) there, which Adam (eps 1e-8) turns into steps
    of about +-lr whose signs are the rounding's."""
    cfg = tiny_cfg.replace(encoder_dropout=0.0, decoder_dropout=0.0,
                           mine_lambda=0.5)
    jmodel, params = flax_params(cfg, seed=8)
    jstate = jsteps.create_train_state(jmodel, cfg, jax.random.PRNGKey(0))
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    mine, jmine_state, port_mine, mine_state = _jax_mine(cfg, 9)
    jstep = jmine_steps.make_mine_train_step(jmodel, mine, cfg)

    tcfg = port_config(cfg)
    model = convert.load_into(make_model(tcfg), params).train()
    state = steps.create_train_state(model, tcfg)
    step = mine_steps.make_mine_train_step(model, port_mine, tcfg)
    gen = torch.Generator().manual_seed(0)
    shape = (cfg.bs, cfg.seq_len, cfg.channel_dim)
    named_t = dict(port_mine.named_parameters())
    adam = optax.adam(1e-3)

    for i, inp in enumerate(_batches(cfg, 3)):
        key = jax.random.PRNGKey(200 + i)
        k_ch, _, k_perm = jax.random.split(key, 3)
        noise = np.asarray(jax.random.normal(k_ch, shape, jnp.float32))
        perm = np.array(jax.random.permutation(k_perm, cfg.bs))
        # T and its Adam state: JAX's, through the bridges
        port_mine.load_state_dict(
            convert.flax_to_state_dict(jmine_state.params))
        before = _adam_state(jmine_state.opt_state)
        convert.load_flax_adam_state(mine_state.optimizer, named_t,
                                     before.mu, before.nu, before.count)
        t_before = jmine_state.params
        jstate, jmine_state, (jce, jmi) = jstep(
            jstate, jmine_state, jnp.asarray(inp), jnp.asarray(inp), key,
            N_STD)
        t = torch.from_numpy(inp).long()
        state, mine_state, (ce, mi) = step(
            state, mine_state, t, t, gen, N_STD, noise=torch.tensor(noise),
            perm=torch.from_numpy(perm))
        np.testing.assert_allclose(ce.item(), float(jce), rtol=1e-5,
                                   err_msg=f"ce at step {i + 1}")
        np.testing.assert_allclose(mi.item(), float(jmi), rtol=1e-5,
                                   err_msg=f"mi at step {i + 1}")
        want = _leaves(_jax_mine_grads(jmodel, mine, cfg, jstate.params,
                                       t_before, inp, key))
        got = _leaves(convert.state_dict_to_flax(
            {n: p.grad for n, p in named_t.items()}, tcfg))
        largest = max(float(np.abs(g).max()) for g in want.values())
        for name in want:
            err = float(np.abs(got[name] - want[name]).max())
            assert err <= 1e-5 * largest, (i, name, err, largest)
        # T's update: optax's Adam on the port's own clipped gradient
        grads = jax.tree.map(jnp.asarray, convert.state_dict_to_flax(
            {n: p.grad for n, p in named_t.items()}, tcfg))
        upd, after = adam.update(grads, (before, optax.EmptyState()))
        assert_close_to_largest(
            named_t, optax.apply_updates(t_before, upd), cfg,
            f"T params at step {i + 1}", over_all=True)
        for key_, tree in (("exp_avg", after[0].mu),
                           ("exp_avg_sq", after[0].nu)):
            assert_close_to_largest(
                {n: mine_state.optimizer.state[p][key_]
                 for n, p in named_t.items()}, tree, cfg,
                f"T {key_} at step {i + 1}", tol=1e-6)

    assert state.step == int(jstate.step) == 3 and mine_state.step == 3
    named = dict(model.named_parameters())
    assert_close_to_largest(named, jstate.params, cfg, "params")
    adam_state = _adam_state(jstate.opt_state)
    assert int(adam_state.count) == 3
    for key_, tree in (("exp_avg", adam_state.mu),
                       ("exp_avg_sq", adam_state.nu)):
        assert_close_to_largest(
            {n: state.optimizer.state[p][key_] for n, p in named.items()},
            tree, cfg, key_)


def test_mine_step_reuses_its_draws_for_the_update(tiny_cfg):
    """With dropout on, T's update sees the symbols of phase 2's masks and
    channel draw on the updated transceiver: its recompute equals a
    forward of the updated model replaying the step's draws (noise,
    permutation, then the masks); the generator ends where phase 2 left
    it, after its decoder's masks too, and no further."""
    cfg = port_config(tiny_cfg.replace(encoder_dropout=0.3,
                                       decoder_dropout=0.3, mine_lambda=0.5))
    model = steps.init_params(make_model(cfg), 1).train()
    state = steps.create_train_state(model, cfg)
    mine, mine_state = mine_steps.create_mine_state(cfg, 2)
    step = mine_steps.make_mine_train_step(model, mine, cfg)
    inp = torch.from_numpy(_batches(tiny_cfg, 1)[0]).long()
    seen = []
    transmit = model.transmit

    def record(tx, *a, **k):
        y = transmit(tx, *a, **k)
        seen.append((tx.detach().clone(), y.detach().clone()))
        return y

    model.transmit = record
    gen = torch.Generator().manual_seed(3)
    step(state, mine_state, inp, inp, gen, N_STD)
    assert len(seen) == 2

    replay = torch.Generator().manual_seed(3)
    noise = torch.randn((cfg.bs, cfg.seq_len, cfg.channel_dim),
                        generator=replay)
    torch.randperm(cfg.bs, generator=replay)
    enc_mask, combined, dec_mask = create_masks(inp, inp[:, :-1],
                                                cfg.pad_idx)
    with torch.no_grad():
        tx = model.encode(inp, enc_mask, replay)
        y = transmit(tx, noise, N_STD, None, 0.0)
        model.decode(inp[:, :-1], y, combined, dec_mask, replay)
    assert torch.equal(seen[1][0], tx) and torch.equal(seen[1][1], y)
    assert not torch.equal(seen[0][0], tx)  # the update moved the encoder
    assert torch.equal(replay.get_state(), gen.get_state())


def _corpus(tmp_path, n=64):
    rows = synthetic_dataset(n, 12, 40, 8, seed=4).data
    path = tmp_path / "train.pkl"
    with open(path, "wb") as f:
        pickle.dump([row[row != 0].tolist() for row in rows], f)
    return str(path)


def test_cli_train_mine_mode(tmp_path):
    """`cli train --train-mode mine` at tiny widths on the CPU: path mine,
    one step a batch, ce and mi finite and logged every 2 steps, the
    recipe records mine_lambda, and an epoch checkpoint is written."""
    res = cli.main(["train", "--device", "cpu", *TINY_FLAGS, "--bs", "8",
                    "--train-mode", "mine", "--mine-lambda", "0.01",
                    "--epochs", "1", "--log-every", "2",
                    "--train-save-path", _corpus(tmp_path),
                    "--log-save-path", str(tmp_path / "log"),
                    "--checkpoint-path", str(tmp_path / "ckpt")])
    assert res["path"] == "mine" and res["steps"] == 8
    assert res["losses"].shape == res["mis"].shape == (8,)
    assert torch.isfinite(res["losses"]).all()
    assert torch.isfinite(res["mis"]).all()
    recs = [json.loads(line) for line in
            (tmp_path / "log" / "train.jsonl").read_text().splitlines()]
    logged = [r for r in recs if "mi" in r]
    assert [r["step"] for r in logged] == [2, 4, 6, 8]
    np.testing.assert_allclose([r["mi"] for r in logged],
                               res["mis"][1::2].numpy(), rtol=1e-6)
    with open(res["params_path"], "rb") as f:
        recipe = pickle.load(f)["recipe"]
    assert recipe["train_mode"] == "mine" and recipe["mine_lambda"] == 0.01
    assert (tmp_path / "ckpt" / "transformer" / "1" / "state.pt").exists()


@pytest.mark.parametrize("variant", ["star", "star_multi", "gan",
                                     "gan_star"])
def test_cli_mine_refuses_every_other_variant(tmp_path, monkeypatch,
                                              variant):
    """Stopped at command start, before a model is built, with the JAX
    step's failure quoted."""
    def refuse(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(cli, "load_model", refuse)
    with pytest.raises(SystemExit) as exc:
        cli.main(["train", "--device", "cpu", "--variant", variant,
                  "--train-mode", "mine",
                  "--log-save-path", str(tmp_path)])
    assert "--variant transformer" in str(exc.value.code)
    assert "Incompatible shapes" in str(exc.value.code)
