"""The port's FGM/PGD attacks against the JAX package's on the CPU at f32,
with the same weights and the channel draws JAX makes from its keys
(dropout off in training: flax's dropout bits cannot be reproduced):
`fgm_normalize` and `pgd_bisection` (rtol 1e-6), three
`make_train_attack_step` steps (losses rtol 1e-5, params atol 1e-5),
`make_eval_step` and `make_eval_step_pgd` (losses rtol 1e-5, argmax ids
identical, eps* to 1e-6) and `make_greedy_decode_attack` (token-identical),
vanilla and star. Also `teacher_forced_sweep`'s table and the CLI's attack
modes."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.data.vocab import Vocab as JaxVocab
from deepsc_gan_tpu.evaluate.evaluator import (
    teacher_forced_sweep as jax_tf_sweep,
)
from deepsc_gan_tpu.evaluate.greedy import (
    make_greedy_decode_attack as jax_greedy_attack,
)
from deepsc_gan_tpu.ops.pallas.attention import set_attn_kernel_mode
from deepsc_gan_tpu.ops.pallas.ce import set_ce_kernel_mode
from deepsc_gan_tpu.ops.schedule import make_optimizer as jax_make_optimizer
from deepsc_gan_tpu.train import attacks as jattacks
from deepsc_gan_tpu.train import steps as jsteps
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_sentences
from deepsc_gan_tpu_torch.data.vocab import Vocab
from deepsc_gan_tpu_torch.evaluate.evaluator import teacher_forced_sweep
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_attack
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.train import attacks, steps
from deepsc_gan_tpu_torch.utils import convert
from test_torch_channel import jax_fading_draws
from test_torch_greedy import TINY_FLAGS
from test_torch_model import flax_params, port_config
from test_torch_star import star_params
from test_torch_train import N_STD, _assert_trees_close, _batches

PNR_DB = 3.0


@pytest.mark.parametrize("case", ["random", "zero", "zero_row"])
def test_fgm_normalize_matches_jax(case):
    rng = np.random.default_rng(0)
    g = rng.standard_normal((4, 6, 8)).astype(np.float32)
    if case == "zero":
        g[:] = 0.0
    elif case == "zero_row":
        g[2] = 0.0
    want = np.asarray(jattacks.fgm_normalize(jnp.asarray(g), 0.7))
    got = attacks.fgm_normalize(torch.tensor(g), 0.7).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if case == "random":  # quirk Q7: epsilon cancels
        np.testing.assert_allclose(
            attacks.fgm_normalize(torch.tensor(g), 5.0).numpy(), got,
            rtol=1e-6)


@pytest.mark.parametrize("clean", [0.5, 2.0, 10.0])
def test_pgd_bisection_matches_jax(clean):
    """A loss that rises with the strength along the direction: the
    bisection's eps and the loss re-evaluated at it (not the loop's last
    loss, which belongs to the previous midpoint)."""
    rng = np.random.default_rng(1)
    d = rng.standard_normal((3, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    w = np.abs(w) * np.sign(d)  # loss grows along d

    def jloss(p):
        return jnp.sum(p * w) * 3.0 + 1.0

    def tloss(p):
        return (p * torch.tensor(w)).sum() * 3.0 + 1.0

    weps, wloss = jattacks.pgd_bisection(jloss, jnp.asarray(d),
                                         jnp.float32(clean))
    eps, loss = attacks.pgd_bisection(tloss, torch.tensor(d),
                                      torch.tensor(clean))
    np.testing.assert_allclose(eps.item(), float(weps), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(wloss), rtol=1e-6)
    np.testing.assert_allclose(loss.item(),
                               tloss(eps * torch.tensor(d)).item(), rtol=0)


def test_fgm_perturbation_is_the_normalized_gradient():
    x = torch.randn((2, 3, 4), generator=torch.Generator().manual_seed(2))
    pert, loss = attacks.fgm_perturbation(lambda t: (t ** 3).sum(), x)
    torch.testing.assert_close(pert, attacks.fgm_normalize(3 * x ** 2))
    torch.testing.assert_close(loss, (x ** 3).sum())
    assert not pert.requires_grad and not x.requires_grad


def _jax_state(params, cfg):
    tx = jax_make_optimizer(cfg.lr, cfg.schedule, cfg.encoder_d_model,
                            cfg.warmup_steps, cfg.decay_steps)
    return jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=tx.init(params), tx=tx,
                             ema_params=None, ema_decay=0.0)


def _models(cfg, variant, seed):
    if variant == "transformer":
        return flax_params(cfg, seed=seed)
    return star_params(cfg, seed, variant)


def _channel_draw(key, cfg, kind):
    """(noise, fade) torch tensors: what the JAX channel `kind` draws from
    `key`."""
    shape = (cfg.bs, cfg.seq_len, cfg.channel_dim)
    if kind == "AWGN":
        return torch.tensor(np.asarray(jax.random.normal(key, shape))), None
    fade, noise = jax_fading_draws(key, *shape, cfg.fading_per_sample)
    return torch.tensor(noise), torch.tensor(fade)


@pytest.fixture
def interpret():
    set_attn_kernel_mode("interpret")
    set_ce_kernel_mode("interpret")
    try:
        yield
    finally:
        set_attn_kernel_mode("auto")
        set_ce_kernel_mode("auto")


# name -> (variant, adv_weight, channel)
ATTACK_STEPS = {"transformer-adv1": ("transformer", 1.0, "AWGN"),
                "transformer-adv0.5-rayleigh": ("transformer", 0.5,
                                                "Rayleigh"),
                "star-adv1": ("star", 1.0, "AWGN"),
                "star-adv0.5": ("star", 0.5, "AWGN")}


def _three_attack_steps(cfg, variant, adv_weight, kind):
    star = variant != "transformer"
    jmodel, params = _models(cfg, variant, 6)
    jstate = _jax_state(params, cfg)
    jstep = jsteps.make_train_attack_step(jmodel, cfg, kind, star,
                                          adv_weight)
    tcfg = port_config(cfg)
    model = convert.load_into(make_model(tcfg, variant), params).train()
    state = steps.create_train_state(model, tcfg)
    step = steps.make_train_attack_step(model, tcfg, star, adv_weight)
    gen = torch.Generator().manual_seed(0)
    for i, inp in enumerate(_batches(cfg, 3)):
        key = jax.random.PRNGKey(300 + i)
        k_ch1, k_ch2, _, _ = jax.random.split(key, 4)
        (n1, f1), (n2, f2) = (_channel_draw(k, cfg, kind)
                              for k in (k_ch1, k_ch2))
        jstate, (wc, wa) = jstep(jstate, jnp.asarray(inp), jnp.asarray(inp),
                                 key, PNR_DB, N_STD, 1.0)
        t = torch.from_numpy(inp).long()
        state, (gc, ga) = step(state, t, t, gen, PNR_DB, N_STD, 1.0,
                               n1, n2, f1, f2)
        np.testing.assert_allclose(gc.item(), float(wc), rtol=1e-5,
                                   err_msg=f"clean loss at step {i + 1}")
        np.testing.assert_allclose(ga.item(), float(wa), rtol=1e-5,
                                   err_msg=f"adv loss at step {i + 1}")
    assert state.step == int(jstate.step) == 3
    _assert_trees_close(dict(model.named_parameters()), jstate.params, cfg,
                        "params")


@pytest.mark.parametrize("case", [c for c in ATTACK_STEPS
                                  if c != "transformer-adv1"])
def test_three_attack_steps_match_jax(tiny_cfg, case):
    variant, adv_weight, kind = ATTACK_STEPS[case]
    cfg = tiny_cfg.replace(encoder_dropout=0.0, decoder_dropout=0.0,
                           channel=kind)
    _three_attack_steps(cfg, variant, adv_weight, kind)


def test_three_attack_steps_match_jax_interpreted(tiny_cfg, interpret):
    """The reference's adversarial-only update, the JAX side through the
    Pallas kernels under the interpreter."""
    cfg = tiny_cfg.replace(encoder_dropout=0.0, decoder_dropout=0.0)
    _three_attack_steps(cfg, "transformer", 1.0, "AWGN")


def test_attack_step_phase_two_shares_draws_and_masks(tiny_cfg):
    """With dropout on and adv_weight < 1, the clean forward of phase 2
    takes the adversarial forward's dropout masks: at epsilon's direction
    scaled to zero power (PNR -inf dB) the two losses are equal, so the
    update equals the adversarial-only update's."""
    cfg = port_config(tiny_cfg)
    inp = torch.from_numpy(_batches(tiny_cfg, 1)[0]).long()
    out = []
    for adv_weight in (1.0, 0.5):
        model = steps.init_params(make_model(cfg), 3).train()
        state = steps.create_train_state(model, cfg)
        step = steps.make_train_attack_step(model, cfg,
                                            adv_weight=adv_weight)
        gen = torch.Generator().manual_seed(7)
        step(state, inp, inp, gen, -1e9, N_STD, 1.0)
        out.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _eval_draws(key, cfg, kind, n):
    """The channel draws of JAX's eval steps from `key` split n ways, in
    the port's `draws` layout."""
    keys = jax.random.split(key, n)
    if n == 2:  # PGD: k1, k2
        return [_channel_draw(k, cfg, kind) for k in keys]
    # FGM: clean k1, the gradient's AWGN pass (k1 for AWGN, else k2), k3
    first = _channel_draw(keys[0], cfg, kind)
    grad = first if kind == "AWGN" else _channel_draw(keys[1], cfg, "AWGN")
    return [first, grad, _channel_draw(keys[2], cfg, kind)]


def _ids(logits):
    return np.asarray(jnp.argmax(jnp.asarray(np.asarray(logits)), axis=-1))


# name -> (variant, step, channel); the FGM steps attack tx, the JAX
# default and what both CLIs run
EVAL_STEPS = {"fgm-tx-awgn": ("transformer", "fgm", "AWGN"),
              "fgm-tx-rayleigh": ("transformer", "fgm", "Rayleigh"),
              "fgm-tx-rician": ("transformer", "fgm", "Rician"),
              "pgd-awgn": ("transformer", "pgd", "AWGN"),
              "pgd-rayleigh": ("transformer", "pgd", "Rayleigh"),
              "star-fgm-tx": ("star", "fgm", "AWGN"),
              "star-fgm-tx-rayleigh": ("star", "fgm", "Rayleigh"),
              "star-pgd": ("star", "pgd", "AWGN")}


@pytest.mark.parametrize("case", list(EVAL_STEPS))
def test_eval_steps_match_jax(tiny_cfg, tiny_batch, case):
    variant, kind_of_step, kind = EVAL_STEPS[case]
    star = variant != "transformer"
    cfg = tiny_cfg.replace(channel=kind)
    jmodel, params = _models(cfg, variant, 8)
    tcfg = port_config(cfg)
    model = convert.load_into(make_model(tcfg, variant), params).eval()
    key = jax.random.PRNGKey(41)
    inp = np.asarray(tiny_batch)
    t = torch.from_numpy(inp).long()
    if kind_of_step == "pgd":
        jstep = jsteps.make_eval_step_pgd(jmodel, cfg, full_target=star)
        step = steps.make_eval_step_pgd(model, tcfg, full_target=star)
        draws = _eval_draws(key, cfg, kind, 2)
    else:
        jstep = jsteps.make_eval_step(jmodel, cfg, full_target=star)
        step = steps.make_eval_step(model, tcfg, full_target=star)
        draws = _eval_draws(key, cfg, kind, 3)
    want = jstep(_jax_state(params, cfg), jnp.asarray(inp),
                 jnp.asarray(inp), key, PNR_DB, N_STD, 1.0)
    got = step(t, t, None, PNR_DB, N_STD, 1.0, draws)
    for i in (0, 1):
        np.testing.assert_allclose(got[i].item(), float(want[i]), rtol=1e-5)
    for i in (2, 3):
        assert got[i].dtype == torch.float32
        np.testing.assert_array_equal(
            torch.argmax(got[i], dim=-1).numpy(), _ids(want[i]))
    if kind_of_step == "pgd":
        assert 0.0 <= got[4].item() <= 1.0
        np.testing.assert_allclose(got[4].item(), float(want[4]), atol=1e-6)


@pytest.mark.parametrize("variant,kind", [("transformer", "AWGN"),
                                          ("transformer", "Rayleigh"),
                                          ("star", "AWGN")])
def test_greedy_decode_attack_token_identical(tiny_cfg, tiny_batch, variant,
                                              kind):
    star = variant != "transformer"
    mode = "oneshot" if star else "step"
    cfg = tiny_cfg.replace(channel=kind)
    jmodel, params = _models(cfg, variant, 9)
    key = jax.random.PRNGKey(51)
    inp = np.asarray(tiny_batch)
    want = np.asarray(jax_greedy_attack(jmodel, cfg, position_mode=mode,
                                        full_target=star)(
        params, jnp.asarray(inp), key, PNR_DB, N_STD, 1.0))
    draws = [_channel_draw(k, cfg, kind) for k in jax.random.split(key)]
    noise = torch.stack([n for n, _ in draws])
    fade = None if kind == "AWGN" else torch.stack([f for _, f in draws])
    tcfg = port_config(cfg)
    model = convert.load_into(make_model(tcfg, variant), params).eval()
    got = make_greedy_decode_attack(model, tcfg, position_mode=mode,
                                    full_target=star)(
        torch.from_numpy(inp).long(), PNR_DB, N_STD, noise, fade, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("length_kind", ["shifted", "star"])
def test_teacher_forced_sweep_table_matches_jax(tiny_cfg, length_kind):
    """The rows [snr, clean BLEU, attacked BLEU, loss clean, loss attacked]
    around fixed step outputs; a star step's predictions (one per input
    position) drop their first slot."""
    rng = np.random.default_rng(5)
    batches = [synthetic_sentences(4, 12, 40, seed=s, max_len=12)
               for s in (0, 1)]
    length = 12 if length_kind == "star" else 11
    clean = rng.standard_normal((4, length, 40)).astype(np.float32)
    attacked = rng.standard_normal((4, length, 40)).astype(np.float32)
    # make the clean predictions mostly right, so the scores differ
    for r, row in enumerate(batches[0]):
        tgt = row if length_kind == "star" else row[1:]
        clean[r, np.arange(length), tgt[:length]] += 5.0

    def jstep(state, inp, tar, k, pnr, n_std, eps):
        return (n_std * 2.0, n_std * 3.0, jnp.asarray(clean),
                jnp.asarray(attacked))

    def tstep(inp, tar, gen, pnr, n_std, eps):
        return (torch.tensor(n_std * 2.0), torch.tensor(n_std * 3.0),
                torch.tensor(clean), torch.tensor(attacked))

    t2i = Vocab.identity(40).token_to_idx
    snrs = [0, 9, 18]
    want = jax_tf_sweep(jstep, None, batches, JaxVocab(t2i), tiny_cfg,
                        snrs=snrs)
    got = teacher_forced_sweep(tstep, batches, Vocab(t2i),
                               port_config(tiny_cfg),
                               torch.Generator().manual_seed(0), snrs=snrs)
    assert [len(row) for row in got] == [5] * 3
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)
    assert got[0][1] > got[0][2]


@pytest.mark.parametrize("variant", ["transformer", "star"])
def test_cli_train_attack_runs_on_cpu(tmp_path, variant):
    """`cli train --train-mode attack` through Rayleigh fading, on a
    training pickle of 256 sentences (4 steps of 64)."""
    rows = synthetic_sentences(256, 12, 40, seed=1, max_len=12)
    with open(tmp_path / "train.pkl", "wb") as f:
        pickle.dump([row[row != 0].tolist() for row in rows], f)
    flags = ["train", "--device", "cpu", "--variant", variant,
             "--train-mode", "attack", "--adv-weight", "0.5", "--pnr-db",
             "0", "--channel", "Rayleigh", *TINY_FLAGS, "--cycle-num", "2",
             "--epochs", "1", "--log-every", "2",
             "--log-save-path", str(tmp_path / "log"),
             "--checkpoint-path", str(tmp_path / "ckpt"),
             "--train-save-path", str(tmp_path / "train.pkl")]
    res = cli.main(flags)
    assert res["steps"] == 256 // 64
    for key in ("losses", "clean_losses"):
        assert res[key].shape == (4,) and torch.isfinite(res[key]).all()
    with open(res["params_path"], "rb") as f:
        recipe = pickle.load(f)["recipe"]
    assert (recipe["train_mode"], recipe["adv_weight"],
            recipe["channel"]) == ("attack", 0.5, "Rayleigh")


@pytest.mark.parametrize("mode", ["teacher_forced", "pgd", "greedy_attack"])
def test_cli_evaluate_attack_modes_run_on_cpu(tmp_path, mode):
    res = cli.main(["evaluate", "--device", "cpu", "--bs", "4",
                    "--eval-mode", mode, "--channel", "Rayleigh",
                    "--pnr-db", "0", "--eval-batches", "1", "--snr-lo", "0",
                    "--snr-hi", "1", "--log-save-path", str(tmp_path),
                    *TINY_FLAGS])
    table = res["table"]
    assert [row[0] for row in table] == [0.0, 1.0]
    assert np.isfinite(np.asarray(table)).all()
    if mode == "greedy_attack":
        assert [len(row) for row in table] == [2, 2]
        name = "test-transformer-greedy_attack.pkl"
    else:
        assert [len(row) for row in table] == [5, 5]
        name = "eval-transformer.pkl"
    with open(tmp_path / name, "rb") as f:
        assert pickle.load(f) == table
    if mode == "pgd":
        assert len(res["eps_star"]) == 2
        assert all(0.0 <= e <= 1.0 for e in res["eps_star"])
