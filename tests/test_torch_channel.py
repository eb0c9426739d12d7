"""The port's channels (`models/channel.py`) against the JAX package's on the
CPU at f32: Rayleigh/Rician fading with every equalizer, one fade per call
and per sample, fed the standard normals JAX draws from the same key, within
rtol 1e-5 and atol 1e-6 (the port multiplies the (re, im) pairs in real
arithmetic, XLA in complex64: a few ulps apart); AWGN through the new
dispatch bit-identical to `awgn`; and the fading sweeps (greedy, KV, beam,
star one-shot) token-identical to the JAX package's on the same draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.evaluate.beam import (
    make_beam_decode_sweep as jax_beam_sweep,
)
from deepsc_gan_tpu.evaluate.greedy import (
    make_greedy_decode_sweep as jax_greedy_sweep,
)
from deepsc_gan_tpu.evaluate.kv_decode import (
    make_greedy_decode_kv_sweep as jax_kv_sweep,
)
from deepsc_gan_tpu.evaluate.metrics import SNR_to_noise as jax_snr_to_noise
from deepsc_gan_tpu.models.channel import channel as jax_channel
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_sentences
from deepsc_gan_tpu_torch.data.vocab import Vocab
from deepsc_gan_tpu_torch.evaluate.beam import make_beam_decode_sweep
from deepsc_gan_tpu_torch.evaluate.evaluator import (
    snr_sweep_bleu,
    snr_sweep_bleu_fast,
)
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_sweep
from deepsc_gan_tpu_torch.evaluate.kv_decode import (
    make_greedy_decode_kv_sweep,
)
from deepsc_gan_tpu_torch.models.channel import (
    awgn,
    channel,
    draw_channel,
    fading,
)
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.utils import convert
from test_torch_greedy import TINY_FLAGS
from test_torch_model import flax_params, port_config
from test_torch_star import star_params

RTOL, ATOL = 1e-5, 1e-6


def jax_fading_draws(key, batch, length, dim, per_sample):
    """(fade, noise) as numpy: the standard normals the JAX fading channel
    draws from `key` (split into the fade's key and the noise's), the
    noise read back as (B, L, C)."""
    kh, kn = jax.random.split(key)
    fade = jax.random.normal(kh, (batch, 1, 2) if per_sample else (2,),
                             jnp.float32)
    noise = jax.random.normal(kn, (batch, length * dim // 2, 2), jnp.float32)
    return np.asarray(fade), np.asarray(noise).reshape(batch, length, dim)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("equalizer", [None, "LS", "MMSE"])
@pytest.mark.parametrize("kind", ["Rayleigh", "Rician"])
def test_fading_matches_jax(kind, equalizer, per_sample):
    key = jax.random.PRNGKey(7)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 6, 8)))
    p = np.ones_like(x)  # accepted and ignored on the fading path
    want = np.asarray(jax_channel(key, jnp.asarray(x), jnp.asarray(p), 3.0,
                                  0.3, kind, equalizer, per_sample))
    fade, noise = jax_fading_draws(key, 4, 6, 8, per_sample)
    got = channel(torch.tensor(x), torch.tensor(noise), 0.3,
                  torch.tensor(p), 3.0, kind, torch.tensor(fade), equalizer)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fading_broadcasts_noise_levels():
    """Leading noise-level axes, as the sweeps give: tx[None] against noise
    (S, B, L, C), n_std (S, 1, 1, 1) and one fade per level equal level by
    level to the single-level channel."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 8), generator=gen)
    noise = torch.randn((4, 3, 5, 8), generator=gen)
    n_std = torch.tensor([0.1, 0.4, 0.9, 2.0])
    for fade in (torch.randn((4, 2), generator=gen),
                 torch.randn((4, 3, 1, 2), generator=gen)):
        got = fading(x[None], fade, noise, n_std.reshape(4, 1, 1, 1), 1.0,
                     "MMSE")
        assert got.shape == (4, 3, 5, 8)
        for s in range(4):
            torch.testing.assert_close(
                got[s], fading(x, fade[s], noise[s], n_std[s], 1.0, "MMSE"),
                rtol=0, atol=0)


def test_bad_equalizer_and_missing_fade_raise():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="equalizer"):
        fading(x, torch.zeros(2), x, 0.1, 0.0, "ZF")
    with pytest.raises(ValueError, match="fade"):
        channel(x, x, 0.1, kind="Rayleigh")


def test_awgn_through_dispatch_is_bit_identical():
    gen = torch.Generator().manual_seed(3)
    x, noise, p = (torch.randn((4, 6, 8), generator=gen) for _ in range(3))
    for pert in (None, p):
        assert torch.equal(channel(x, noise, 0.2, pert, 2.0, "AWGN"),
                           awgn(x, noise, 0.2, pert, 2.0))


def test_sweeps_draw_the_fade_after_the_noise(tiny_cfg):
    """snr_sweep_bleu_fast and snr_sweep_bleu draw each call's noise, then
    for a fading channel its fade, from the generator; AWGN draws the noise
    alone, as before."""
    batches = [synthetic_sentences(4, 12, 40, seed=0, max_len=12)]
    vocab = Vocab.identity(40)
    for kind, per_sample in (("AWGN", False), ("Rayleigh", False),
                             ("Rician", True)):
        cfg = port_config(tiny_cfg, channel=kind,
                          fading_per_sample=per_sample)
        seen = []

        def fake(inp, pnr_db, n_std, noise, fade=None):
            seen.append((noise, fade))
            lead = noise.shape[:-3]
            return inp.expand(lead + inp.shape)

        snr_sweep_bleu_fast(fake, batches, vocab, cfg,
                            torch.Generator().manual_seed(5), snrs=[0, 9])
        snr_sweep_bleu(fake, batches, vocab, cfg,
                       torch.Generator().manual_seed(6), snrs=[0, 9])
        for (noise, fade), seed, lead in ((seen[0], 5, (2,)),
                                          (seen[1], 6, ())):
            want = draw_channel(torch.Generator().manual_seed(seed),
                                (4, 12, cfg.channel_dim), kind, per_sample,
                                lead)
            assert torch.equal(noise, want[0])
            if kind == "AWGN":
                assert fade is None and want[1] is None
            else:
                assert torch.equal(fade, want[1])
                assert fade.shape == lead + ((4, 1, 2) if per_sample
                                             else (2,))


def sweep_draws(key, n_levels, batch, cfg):
    """(noise (S, B, L, C), fade (S, 2) or (S, B, 1, 2)): the draws of a
    JAX sweep's fading channel, one key per level."""
    draws = [jax_fading_draws(k, batch, cfg.seq_len, cfg.channel_dim,
                              cfg.fading_per_sample)
             for k in jax.random.split(key, n_levels)]
    return (torch.tensor(np.stack([n for _, n in draws])),
            torch.tensor(np.stack([f for f, _ in draws])))


# name -> (variant, channel, equalizer, per-sample, JAX sweep, port sweep)
SWEEPS = {
    "greedy-rayleigh": ("transformer", "Rayleigh", None, False,
                        lambda m, c: jax_greedy_sweep(m, c),
                        lambda m, c: make_greedy_decode_sweep(m, c)),
    "greedy-rician-mmse-per-sample": (
        "transformer", "Rician", "MMSE", True,
        lambda m, c: jax_greedy_sweep(m, c),
        lambda m, c: make_greedy_decode_sweep(m, c)),
    "kv-rician-ls": ("transformer", "Rician", "LS", False,
                     lambda m, c: jax_kv_sweep(m, c),
                     lambda m, c: make_greedy_decode_kv_sweep(m, c)),
    "beam2-rayleigh-mmse": (
        "transformer", "Rayleigh", "MMSE", False,
        lambda m, c: jax_beam_sweep(m, c, beam_size=2),
        lambda m, c: make_beam_decode_sweep(m, c, 2)),
    "star-oneshot-rayleigh": (
        "star", "Rayleigh", None, False,
        lambda m, c: jax_greedy_sweep(m, c, position_mode="oneshot"),
        lambda m, c: make_greedy_decode_sweep(m, c, "oneshot")),
}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_fading_sweep_token_identical(tiny_cfg, case):
    variant, kind, eq, per_sample, jax_make, port_make = SWEEPS[case]
    jcfg = tiny_cfg.replace(channel=kind, equalizer=eq,
                            fading_per_sample=per_sample)
    if variant == "transformer":
        jmodel, params = flax_params(jcfg, seed=2)
    else:
        jmodel, params = star_params(jcfg, 2, variant)
    inp = synthetic_sentences(jcfg.bs, jcfg.seq_len, jcfg.vocab_size,
                              seed=2, max_len=jcfg.seq_len)
    snrs = [0, 6, 18]
    n_stds = np.asarray([jax_snr_to_noise(s) for s in snrs], np.float32)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jax_make(jmodel, jcfg)(params, jnp.asarray(inp), key,
                                             0.0, jnp.asarray(n_stds)))
    tcfg = port_config(jcfg)
    model = convert.load_into(make_model(tcfg, variant), params).eval()
    noise, fade = sweep_draws(key, len(snrs), jcfg.bs, jcfg)
    got = port_make(model, tcfg)(torch.tensor(inp, dtype=torch.long), 0.0,
                                 torch.from_numpy(n_stds), noise, fade)
    np.testing.assert_array_equal(got.numpy(), want)


def test_transmit_without_fade_raises(tiny_cfg):
    tcfg = port_config(tiny_cfg, channel="Rician")
    model = make_model(tcfg)
    tx = torch.zeros((2, 12, tcfg.channel_dim))
    with pytest.raises(ValueError, match="fade"):
        model.transmit(tx, tx, 0.1)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_cli_evaluate_fading_runs_on_cpu(tmp_path, mode):
    res = cli.main(["evaluate", "--device", "cpu", "--bs", "4",
                    "--eval-mode", mode, "--beam-size", "2",
                    "--channel", "Rician", "--equalizer", "MMSE",
                    "--fading-per-sample", "--eval-batches", "1",
                    "--snr-lo", "0", "--snr-hi", "1",
                    "--log-save-path", str(tmp_path), *TINY_FLAGS])
    assert [row[0] for row in res["table"]] == [0.0, 1.0]
    assert all(0.0 <= row[1] <= 1.0 for row in res["table"])
    assert (tmp_path / f"test-transformer-{mode}.pkl").exists()
