"""The port's beam search (`evaluate/beam.py`) against the JAX package's on
the CPU at f32: `make_beam_decode_kv` and `make_beam_decode` give the JAX
package's ids and each other's, beam size 1 is greedy up to <END>, the
sweep is its per-level calls, and `cli evaluate --eval-mode beam` writes its
table. The channel noise is the standard normal JAX draws from the decode's
key; the port's candidate scorer runs its plain version (CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.evaluate.beam import (
    make_beam_decode as jax_make_beam,
    make_beam_decode_kv as jax_make_beam_kv,
    make_beam_decode_sweep as jax_make_beam_sweep,
)
from deepsc_gan_tpu.evaluate.metrics import SNR_to_noise as jax_snr_to_noise
from deepsc_gan_tpu.models.transceiver import make_model as make_flax_model
from deepsc_gan_tpu.utils.config import Config as JaxConfig
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_sentences
from deepsc_gan_tpu_torch.evaluate.beam import (
    make_beam_decode,
    make_beam_decode_kv,
    make_beam_decode_sweep,
)
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.utils import convert
from test_torch_greedy import TINY_FLAGS
from test_torch_model import TRAINED, flax_params, port_config


def _upto_end(ids, end_idx):
    """Everything after the first <END> zeroed: greedy keeps emitting past
    <END>, beam search freezes a finished beam."""
    out = np.zeros_like(ids)
    for r, row in enumerate(ids):
        end = np.where(row == end_idx)[0]
        upto = end[0] + 1 if len(end) else len(row)
        out[r, :upto] = row[:upto]
    return out


def _port_model(cfg, params):
    tcfg = port_config(cfg)
    return tcfg, convert.load_into(make_model(tcfg), params).eval()


@pytest.mark.parametrize("K,tie", [(1, False), (4, False), (4, True)])
def test_beam_token_identical_to_jax(tiny_cfg, K, tie):
    """KV and full-prefix beams, port and JAX: four equal id arrays."""
    cfg = tiny_cfg.replace(tie_embeddings=tie)
    jmodel, params = flax_params(cfg, seed=K + tie)
    inp = synthetic_sentences(cfg.bs, cfg.seq_len, cfg.vocab_size,
                              seed=K, max_len=cfg.seq_len)
    key = jax.random.PRNGKey(11)
    n_std = 0.3
    want_kv = np.asarray(jax_make_beam_kv(jmodel, cfg, beam_size=K)(
        params, jnp.asarray(inp), key, 0.0, n_std))
    want_full = np.asarray(jax_make_beam(jmodel, cfg, beam_size=K)(
        params, jnp.asarray(inp), key, 0.0, n_std))
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, (cfg.bs, cfg.seq_len, cfg.channel_dim), jnp.float32)))
    tcfg, model = _port_model(cfg, params)
    args = (torch.from_numpy(inp).long(), 0.0, n_std, noise)
    kv = make_beam_decode_kv(model, tcfg, K)(*args).numpy()
    full = make_beam_decode(model, tcfg, K)(*args).numpy()
    assert kv.shape == (cfg.bs, cfg.max_length + 1) and kv.dtype == np.int32
    np.testing.assert_array_equal(want_kv, want_full)
    np.testing.assert_array_equal(kv, want_kv)
    np.testing.assert_array_equal(full, want_kv)


def test_beam_size_1_is_greedy_up_to_end(tiny_cfg):
    _, params = flax_params(tiny_cfg, seed=7)
    tcfg, model = _port_model(tiny_cfg, params)
    gen = torch.Generator().manual_seed(1)
    inp = torch.from_numpy(synthetic_sentences(4, 12, 40, seed=7,
                                               max_len=12)).long()
    for n_std in (0.05, 0.6):
        noise = torch.randn((4, 12, tcfg.channel_dim), generator=gen)
        greedy = make_greedy_decode(model, tcfg)(inp, 0.0, n_std, noise)
        beam = make_beam_decode_kv(model, tcfg, 1)(inp, 0.0, n_std, noise)
        np.testing.assert_array_equal(_upto_end(beam.numpy(), tcfg.end_idx),
                                      _upto_end(greedy.numpy(),
                                                tcfg.end_idx))


def test_beam_sweep_equals_per_level_calls(tiny_cfg):
    _, params = flax_params(tiny_cfg, seed=8)
    tcfg, model = _port_model(tiny_cfg, params)
    gen = torch.Generator().manual_seed(2)
    inp = torch.from_numpy(synthetic_sentences(4, 12, 40, seed=8,
                                               max_len=12)).long()
    n_stds = torch.tensor([0.9, 0.3, 0.05])
    noise = torch.randn((3, 4, 12, tcfg.channel_dim), generator=gen)
    swept = make_beam_decode_sweep(model, tcfg, 3)(inp, 0.0, n_stds, noise)
    assert swept.shape == (3, 4, tcfg.max_length + 1)
    decode = make_beam_decode_kv(model, tcfg, 3)
    for s in range(3):
        assert torch.equal(swept[s],
                           decode(inp, 0.0, float(n_stds[s]), noise[s]))


def test_beam_sweep_token_identical_trained_weights():
    """The committed trained transceiver (tied, full width, V = 22,234),
    beam 4 at B = 2 and 2 SNRs, against the JAX package's beam sweep."""
    params = convert.load_params_pickle(TRAINED)
    cfg = JaxConfig(tie_embeddings=True, dtype="float32", bs=2)
    jmodel = make_flax_model(cfg, "transformer")
    inp = synthetic_sentences(2, cfg.seq_len, cfg.vocab_size, seed=5)
    key = jax.random.PRNGKey(3)
    snrs = [1, 7]
    n_stds = np.asarray([jax_snr_to_noise(s) for s in snrs], np.float32)
    want = np.asarray(jax_make_beam_sweep(jmodel, cfg, beam_size=4)(
        params, jnp.asarray(inp), key, 0.0, jnp.asarray(n_stds)))
    noise = np.stack([np.asarray(jax.random.normal(
        k, (2, cfg.seq_len, cfg.channel_dim), jnp.float32))
        for k in jax.random.split(key, len(snrs))])
    tcfg, model = _port_model(cfg, params)
    got = make_beam_decode_sweep(model, tcfg, 4)(
        torch.from_numpy(inp).long(), 0.0, torch.from_numpy(n_stds),
        torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["kv", "full"])
def test_cli_evaluate_beam_runs_on_cpu(tmp_path, impl):
    res = cli.main(["evaluate", "--device", "cpu", "--eval-mode", "beam",
                    "--beam-size", "3", "--beam-impl", impl, "--bs", "4",
                    "--eval-batches", "2", "--snr-lo", "0", "--snr-hi", "2",
                    "--log-save-path", str(tmp_path), *TINY_FLAGS])
    assert [row[0] for row in res["table"]] == [0.0, 1.0, 2.0]
    assert all(0.0 <= row[1] <= 1.0 for row in res["table"])
    assert len(res["decode_seconds"]) == 3 * 2  # one call per SNR and batch
    assert (tmp_path / "test-transformer-beam.pkl").exists()
