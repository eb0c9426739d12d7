"""The port's GAN slice against the JAX package's on the CPU at f32, with
the same weights through the bridge and the channel draws JAX makes from
its keys (dropout off in training: flax's dropout bits cannot be
reproduced): the generator and discriminator networks (rtol 1e-5), the
GAN transceiver's forward, three `make_gan_train_step` steps (losses rtol
1e-5; params, Adam moments and the shared count atol 1e-5; under the noam
schedule too, where a wrong count shows at the first step), the phase
masks and the frozen leaves, `make_gan_eval_step` (losses rtol 1e-5, ids
identical) and `make_greedy_decode_gan` (ids and noa identical), for
`gan` and `gan_star`; the bridge on the committed GAN weights; the CLI's
GAN commands."""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.evaluate.greedy import (
    make_greedy_decode_gan as jax_greedy_gan,
)
from deepsc_gan_tpu.models import gan as jgan
from deepsc_gan_tpu.models.transceiver import make_model as make_flax_model
from deepsc_gan_tpu.ops.masks import create_masks as jax_create_masks
from deepsc_gan_tpu.train import gan_steps as jgan_steps
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_sentences
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_gan
from deepsc_gan_tpu_torch.models import gan
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.train import gan_steps, steps
from deepsc_gan_tpu_torch.utils import convert
from deepsc_gan_tpu_torch.utils.config import Config
from test_torch_attacks import PNR_DB, _channel_draw, _ids, _jax_state
from test_torch_greedy import TINY_FLAGS
from test_torch_model import _leaves, port_config
from test_torch_train import N_STD, _adam_state, _assert_trees_close, _batches

GAN_PARAMS = str(Path(__file__).resolve().parent.parent / "results"
                 / "gan_params.pkl")


def _cfg(tiny_cfg, variant, **kw):
    seq_len = 11 if variant == "gan_star" else tiny_cfg.seq_len
    return tiny_cfg.replace(seq_len=seq_len, encoder_dropout=0.0,
                            decoder_dropout=0.0, **kw)


def gan_params(cfg, variant, seed):
    """(flax model, params) of `variant`: the port's init through the
    bridge (no flax init to compile), every leaf moved by N(0, 0.1) noise
    from numpy."""
    model = steps.init_params(make_model(port_config(cfg), variant), seed)
    tree = convert.state_dict_to_flax(model.state_dict(), port_config(cfg))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: jnp.asarray(a + 0.1 * rng.standard_normal(a.shape)
                              .astype(np.float32)), tree)
    return make_flax_model(cfg, variant), params


def _port(cfg, variant, params):
    return convert.load_into(make_model(port_config(cfg), variant), params)


def _batch(cfg, seed=0):
    rows = synthetic_sentences(cfg.bs, cfg.seq_len, cfg.vocab_size,
                               seed=seed, max_len=cfg.seq_len)
    return rows.astype(np.int32)


# name -> (flax module, port module, input width)
NETS = {
    "generator": (lambda: jgan.Generator(24, 8),
                  lambda L: gan.Generator(8, 24, 8), 8),
    "discriminator": (lambda: jgan.Discriminator(),
                      lambda L: gan.Discriminator(16), 16),
    "generator_cnn": (lambda: jgan.GeneratorCNN(),
                      lambda L: gan.GeneratorCNN(L, 8), 8),
    "discriminator_cnn": (lambda: jgan.DiscriminatorCNN(),
                          lambda L: gan.DiscriminatorCNN(L, 8), 8),
}


@pytest.mark.parametrize("name", list(NETS))
def test_gan_networks_match_jax(name):
    """Each network on the same input and weights (flax's init moved by
    noise, so the LayerNorm's per-position scale is not 1), and the
    bridge's round trip of its weights."""
    make_j, make_t, width = NETS[name]
    length = 12
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, length, width)).astype(np.float32)
    jnet = make_j()
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape)
                          .astype(np.float32), params)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    net = make_t(length)
    net.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    back = _leaves(convert.state_dict_to_flax(net.state_dict(), Config()))
    for k, v in _leaves(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    if name.startswith("generator"):  # half unit power over the tensor
        np.testing.assert_allclose(np.mean(got ** 2), 0.5, rtol=1e-5)
    # the port's own init (flax's initialisers, the convs' included) runs
    with torch.no_grad():
        assert torch.isfinite(steps.init_params(make_t(length), 0)(
            torch.tensor(x))).all()


@pytest.mark.parametrize("variant", ["gan", "gan_star"])
def test_gan_transceiver_forward_matches_jax(tiny_cfg, variant):
    """(pred_p, pred_r, tx, y_r) with the generator's perturbation at PNR
    3 dB on the JAX channel's two draws."""
    cfg = _cfg(tiny_cfg, variant)
    jmodel, params = gan_params(cfg, variant, 1)
    model = _port(cfg, variant, params).eval()
    inp = _batch(cfg)
    key = jax.random.PRNGKey(11)
    ji = jnp.asarray(inp)
    jm = jax_create_masks(ji, ji[:, :-1], cfg.pad_idx)
    p0 = jnp.zeros((cfg.bs, cfg.seq_len, cfg.channel_dim))
    want = jmodel.apply({"params": params}, ji, ji[:, :-1], key, p0, PNR_DB,
                        "AWGN", N_STD, *jm, deterministic=True,
                        traingan=True)
    (n_p, _), (n_r, _) = (_channel_draw(k, cfg, "AWGN")
                          for k in jax.random.split(key))
    t = torch.from_numpy(inp).long()
    tm = create_masks(t, t[:, :-1], cfg.pad_idx)
    with torch.no_grad():
        got = model(t, t[:, :-1], n_p, n_r, N_STD, None, PNR_DB, *tm,
                    traingan=True)
    for name, a, b in zip(("pred_p", "pred_r", "tx", "y_r"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_phase_masks_partition_the_parameters(tiny_cfg):
    model = make_model(port_config(_cfg(tiny_cfg, "gan")), "gan")
    names = [n for n, _ in model.named_parameters()]
    gen = gan_steps.phase_mask(model, include=(gan_steps.GENERATOR,))
    codec = gan_steps.phase_mask(model, exclude=(gan_steps.GENERATOR,))
    rx = gan_steps.phase_mask(model, exclude=gan_steps.TX_SIDE)
    for n in names:
        top = n.split(".")[0]
        assert gen[n] == (top == "generator")
        assert codec[n] == (top != "generator")
        assert rx[n] == (top in ("channel_decoder", "semantic_decoder"))
    assert any(gen.values()) and any(rx.values())


def test_selective_update_leaves_masked_parameters_bitwise(tiny_cfg):
    """A full update, then a generator-only one: every other parameter and
    its Adam moments bitwise as they were, the generator's moved; the
    shared count at 2 and each generator parameter's step with it."""
    cfg = port_config(_cfg(tiny_cfg, "gan"))
    model = steps.init_params(make_model(cfg, "gan"), 2)
    state = steps.create_train_state(model, cfg)
    ones = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    gan_steps.selective_update(state, ones,
                               {n: True for n in ones})
    before = {n: (p.detach().clone(),
                  state.optimizer.state[p]["exp_avg"].clone(),
                  state.optimizer.state[p]["exp_avg_sq"].clone())
              for n, p in model.named_parameters()}
    mask = gan_steps.phase_mask(model, include=(gan_steps.GENERATOR,))
    gan_steps.selective_update(state, ones, mask)
    assert state.step == 2
    for n, p in model.named_parameters():
        st = state.optimizer.state[p]
        now = (p.detach(), st["exp_avg"], st["exp_avg_sq"])
        same = [torch.equal(a, b) for a, b in zip(now, before[n])]
        if mask[n]:
            assert not any(same[:2]), n
            assert st["step"].item() == 2.0
        else:
            assert all(same), n
            assert st["step"].item() == 1.0


# name -> (variant, Config fields)
GAN_STEPS = {"gan": ("gan", {}),
             "gan_star": ("gan_star", {}),
             "gan-noam-ema": ("gan", dict(schedule="noam", warmup_steps=40,
                                          ema_decay=0.9)),
             "gan-rayleigh-logits": ("gan", dict(channel="Rayleigh",
                                                 fused_ce=False))}


@pytest.mark.parametrize("case", list(GAN_STEPS))
def test_three_gan_steps_match_jax(tiny_cfg, case):
    variant, fields = GAN_STEPS[case]
    star = variant == "gan_star"
    cfg = _cfg(tiny_cfg, variant, **fields)
    kind = cfg.channel
    jmodel, params = gan_params(cfg, variant, 6)
    jstate = _jax_state(params, cfg)
    if cfg.ema_decay:
        jstate = jstate.replace(ema_params=jax.tree.map(jnp.copy, params),
                                ema_decay=cfg.ema_decay)
    jstep = jgan_steps.make_gan_train_step(jmodel, cfg, kind,
                                           full_target=star)
    tcfg = port_config(cfg)
    model = _port(cfg, variant, params).train()
    state = steps.create_train_state(model, tcfg)
    step = gan_steps.make_gan_train_step(model, tcfg, full_target=star)
    gen = torch.Generator().manual_seed(0)
    for i, inp in enumerate(_batches(cfg, 3)):
        key = jax.random.PRNGKey(600 + i)
        _, k_ch, _ = jax.random.split(key, 3)
        (n_p, f_p), (n_r, f_r) = (_channel_draw(k, cfg, kind)
                                  for k in jax.random.split(k_ch))
        jstate, want = jstep(jstate, jnp.asarray(inp), jnp.asarray(inp),
                             key, N_STD)
        t = torch.from_numpy(inp).long()
        state, got = step(state, t, t, gen, N_STD, n_p, n_r, f_p, f_r)
        for name, a, b in zip(("loss", "g_loss", "d_loss"), got, want):
            np.testing.assert_allclose(a.item(), float(b), rtol=1e-5,
                                       err_msg=f"{name} at step {i + 1}")
    adam = _adam_state(jstate.opt_state)
    assert state.step == int(jstate.step) == int(adam.count) == 9
    named = dict(model.named_parameters())
    _assert_trees_close(named, jstate.params, cfg, "params")
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        _assert_trees_close(
            {n: state.optimizer.state[p][key] for n, p in named.items()},
            tree, cfg, key)
    if cfg.ema_decay:
        _assert_trees_close(steps.eval_params(state), jstate.ema_params,
                            cfg, "ema")


def _eval_key_draws(key, cfg, kind):
    """The draws of JAX's GAN eval step from `key`: the clean forward's
    (k1), and the perturbed branch's (the first half of k2)."""
    k1, k2 = jax.random.split(key)
    return [_channel_draw(k1, cfg, kind),
            _channel_draw(jax.random.split(k2)[0], cfg, kind)]


@pytest.mark.parametrize("variant,kind", [("gan", "AWGN"),
                                          ("gan", "Rayleigh"),
                                          ("gan_star", "AWGN")])
def test_gan_eval_step_matches_jax(tiny_cfg, variant, kind):
    star = variant == "gan_star"
    cfg = _cfg(tiny_cfg, variant, channel=kind)
    jmodel, params = gan_params(cfg, variant, 8)
    model = _port(cfg, variant, params).eval()
    key = jax.random.PRNGKey(41)
    inp = _batch(cfg, 1)
    jstep = jgan_steps.make_gan_eval_step(jmodel, cfg, full_target=star)
    want = jstep(_jax_state(params, cfg), jnp.asarray(inp), jnp.asarray(inp),
                 key, PNR_DB, N_STD, 1.0)
    t = torch.from_numpy(inp).long()
    got = gan_steps.make_gan_eval_step(model, port_config(cfg),
                                       full_target=star)(
        t, t, None, PNR_DB, N_STD, 1.0, _eval_key_draws(key, cfg, kind))
    for i in (0, 1):
        np.testing.assert_allclose(got[i].item(), float(want[i]), rtol=1e-5)
    for i in (2, 3):
        assert got[i].dtype == torch.float32
        np.testing.assert_array_equal(
            torch.argmax(got[i], dim=-1).numpy(), _ids(want[i]))


@pytest.mark.parametrize("variant,kind", [("gan", "AWGN"),
                                          ("gan", "Rician"),
                                          ("gan_star", "AWGN")])
def test_greedy_decode_gan_token_identical(tiny_cfg, variant, kind):
    star = variant == "gan_star"
    mode = "oneshot" if star else "step"
    cfg = _cfg(tiny_cfg, variant, channel=kind)
    jmodel, params = gan_params(cfg, variant, 9)
    key = jax.random.PRNGKey(51)
    inp = _batch(cfg, 2)
    want_ids, want_noa = jax_greedy_gan(jmodel, cfg, position_mode=mode,
                                        full_target=star)(
        params, jnp.asarray(inp), key, PNR_DB, N_STD, 1.0)
    draws = [_channel_draw(k, cfg, kind) for k in jax.random.split(key)]
    noise = torch.stack([n for n, _ in draws])
    fade = None if kind == "AWGN" else torch.stack([f for _, f in draws])
    model = _port(cfg, variant, params).eval()
    ids, noa = make_greedy_decode_gan(model, port_config(cfg),
                                      position_mode=mode, full_target=star)(
        torch.from_numpy(inp).long(), PNR_DB, N_STD, noise, fade, 1.0)
    assert noa.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(noa.numpy(), np.asarray(want_noa))


def test_bridge_round_trip_on_the_trained_gan_weights():
    """results/gan_params.pkl (tied, full width) into the port's GAN
    transceiver and back: every leaf bitwise, the generator's included."""
    tree = convert.load_params_pickle(GAN_PARAMS)
    assert set(tree) == {"channel_decoder", "channel_encoder", "generator",
                         "semantic_decoder", "semantic_encoder"}
    cfg = Config(tie_embeddings=convert.is_tied(tree))
    model = convert.load_into(make_model(cfg, "gan"), tree)
    back = _leaves(convert.state_dict_to_flax(model.state_dict(), cfg))
    want = _leaves(tree)
    assert sorted(back) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(back[name], want[name], err_msg=name)


@pytest.fixture(scope="module")
def trained_gan(tmp_path_factory):
    """`cli train --variant gan --train-mode gan` on a training pickle of
    256 sentences (4 steps of 64), through Rayleigh fading."""
    tmp = tmp_path_factory.mktemp("gan")
    rows = synthetic_sentences(256, 12, 40, seed=1, max_len=12)
    with open(tmp / "train.pkl", "wb") as f:
        pickle.dump([row[row != 0].tolist() for row in rows], f)
    res = cli.main(["train", "--device", "cpu", "--variant", "gan",
                    "--train-mode", "gan", "--channel", "Rayleigh",
                    *TINY_FLAGS, "--epochs", "1", "--log-every", "2",
                    "--log-save-path", str(tmp / "log"),
                    "--checkpoint-path", str(tmp / "ckpt"),
                    "--train-save-path", str(tmp / "train.pkl")])
    return tmp, res


def test_cli_train_gan_runs_on_cpu(trained_gan):
    tmp, res = trained_gan
    assert res["steps"] == 4
    for key in ("losses", "g_losses", "d_losses"):
        assert res[key].shape == (4,) and torch.isfinite(res[key]).all()
    with open(res["params_path"], "rb") as f:
        blob = pickle.load(f)
    assert res["params_path"].endswith("gan_params.pkl")
    assert "generator" in blob["params"]
    assert (blob["recipe"]["train_mode"], blob["recipe"]["steps"],
            blob["recipe"]["optimizer_updates"]) == ("gan", 4, 12)
    logged = (tmp / "log" / "train.jsonl").read_text()
    assert '"g_loss"' in logged and '"d_loss"' in logged


@pytest.mark.parametrize("mode", ["greedy_gan", "teacher_forced", "pgd",
                                  "greedy", "greedy_kv", "beam"])
def test_cli_evaluate_gan_modes_run_on_cpu(trained_gan, mode):
    """`cli evaluate --variant gan` on the weights `train` saved: the
    greedy_gan sweep, the teacher-forced table, which `pgd` also runs for a
    GAN model (as the JAX CLI does), and the codec's own decoders (greedy,
    KV, beam)."""
    tmp, res = trained_gan
    flags = ["--eval-mode", mode]
    if mode == "greedy_kv":
        flags = ["--eval-mode", "greedy", "--kv-cache"]
    out = cli.main(["evaluate", "--device", "cpu", "--variant", "gan",
                    "--bs", "4", *flags, "--channel",
                    "Rayleigh", "--eval-batches", "1", "--snr-lo", "0",
                    "--snr-hi", "1", "--checkpoint-path", str(tmp / "ckpt"),
                    "--log-save-path", str(tmp / mode), *TINY_FLAGS])
    assert out["params_path"] == res["params_path"]
    table = out["table"]
    assert [row[0] for row in table] == [0.0, 1.0]
    assert np.isfinite(np.asarray(table)).all()
    width = 5 if mode in ("teacher_forced", "pgd") else 2
    assert [len(row) for row in table] == [width, width]
    assert out["eps_star"] == []


def test_cli_gan_star_trains_and_decodes_on_cpu(tmp_path):
    """gan_star counts as star: seq_len 31 unless set, the un-shifted
    target, one-shot decoding; trained on a pickle of 64 sentences (4
    steps of 16)."""
    rows = synthetic_sentences(64, 11, 40, seed=1, max_len=11)
    with open(tmp_path / "train.pkl", "wb") as f:
        pickle.dump([row[row != 0].tolist() for row in rows], f)
    flags = [*TINY_FLAGS, "--cycle-num", "2", "--log-save-path",
             str(tmp_path / "log"), "--checkpoint-path",
             str(tmp_path / "ckpt")]
    flags[flags.index("--seq-len") + 1] = "11"
    res = cli.main(["train", "--device", "cpu", "--variant", "gan_star",
                    "--train-mode", "gan", "--epochs", "1", "--bs", "16",
                    "--train-save-path", str(tmp_path / "train.pkl"),
                    *flags])
    assert res["steps"] == 4 and torch.isfinite(res["losses"]).all()
    out = cli.main(["evaluate", "--device", "cpu", "--variant", "gan_star",
                    "--bs", "4", "--eval-mode", "greedy_gan",
                    "--eval-batches", "1", "--snr-lo", "3", "--snr-hi", "3",
                    *flags])
    assert out["params_path"] == res["params_path"]
    assert np.isfinite(np.asarray(out["table"])).all()
    assert cli.variant_config(cli.build_parser().parse_args(
        ["train", "--variant", "gan_star"])).seq_len == 31


def test_cli_refuses_gan_training_of_a_codec_without_a_generator():
    with pytest.raises(SystemExit, match="--train-mode gan"):
        cli.main(["train", "--device", "cpu", "--train-mode", "gan"])
