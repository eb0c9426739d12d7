"""The port's greedy BLEU-vs-SNR sweep against the JAX package's
`make_greedy_decode_sweep` on the CPU at f32: the same weights, inputs and
channel noise (the standard normals JAX draws from the keys its sweep
splits) must give token-identical ids. Also the sweep's scoring and the
CLI entry point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.evaluate.evaluator import (
    snr_sweep_bleu_fast as jax_sweep_bleu,
)
from deepsc_gan_tpu.evaluate.greedy import (
    make_greedy_decode as jax_make_decode,
    make_greedy_decode_sweep as jax_make_sweep,
)
from deepsc_gan_tpu.evaluate.metrics import SNR_to_noise as jax_snr_to_noise
from deepsc_gan_tpu.models.transceiver import make_model as make_flax_model
from deepsc_gan_tpu.ops.pallas.attention import set_attn_kernel_mode
from deepsc_gan_tpu.data.vocab import Vocab as JaxVocab
from deepsc_gan_tpu.utils.config import Config as JaxConfig
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_sentences
from deepsc_gan_tpu_torch.data.vocab import Vocab
from deepsc_gan_tpu_torch.evaluate.evaluator import snr_sweep_bleu_fast
from deepsc_gan_tpu_torch.evaluate.greedy import (
    make_greedy_decode,
    make_greedy_decode_sweep,
)
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.utils import convert
from test_torch_model import TRAINED, flax_params, port_config

TINY_FLAGS = ["--vocab-size", "40", "--seq-len", "12", "--max-length", "11",
              "--encoder-num-layer", "2", "--decoder-num-layer", "2",
              "--encoder-d-model", "16", "--decoder-d-model", "16",
              "--encoder-d-ff", "32", "--decoder-d-ff", "32",
              "--encoder-num-heads", "2", "--decoder-num-heads", "2",
              "--channel-hidden", "24", "--channel-dim", "8",
              "--channel-dec-hidden", "32", "--dtype", "float32"]


def _both_sweeps(jcfg, jmodel, params, inp, snrs, seed):
    """(JAX ids, port ids), each (S, B, max_length+1)."""
    key = jax.random.PRNGKey(seed)
    n_stds = np.asarray([jax_snr_to_noise(s) for s in snrs], np.float32)
    want = np.asarray(jax_make_sweep(jmodel, jcfg)(
        params, jnp.asarray(inp), key, 0.0, jnp.asarray(n_stds)))
    shape = (inp.shape[0], jcfg.seq_len, jcfg.channel_dim)
    noise = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                      for k in jax.random.split(key, len(snrs))])
    tcfg = port_config(jcfg)
    model = convert.load_into(make_model(tcfg), params).eval()
    got = make_greedy_decode_sweep(model, tcfg)(
        torch.tensor(inp, dtype=torch.long), 0.0, torch.from_numpy(n_stds),
        torch.tensor(noise)).numpy()
    return want, got


@pytest.mark.parametrize("seed,tie", [(0, False), (1, True)])
def test_sweep_token_identical_tiny(tiny_cfg, seed, tie):
    """Full sweep on tiny_cfg, 4 SNRs, the JAX side through the attention
    kernel under the Pallas interpreter."""
    jcfg = tiny_cfg.replace(tie_embeddings=tie)
    jmodel, params = flax_params(jcfg, seed=seed)
    inp = synthetic_sentences(jcfg.bs, jcfg.seq_len, jcfg.vocab_size,
                              seed=seed, max_len=jcfg.seq_len)
    set_attn_kernel_mode("interpret")
    try:
        want, got = _both_sweeps(jcfg, jmodel, params, inp, [0, 4, 8, 18],
                                 seed)
    finally:
        set_attn_kernel_mode("auto")
    assert want.shape == (4, jcfg.bs, jcfg.max_length + 1)
    np.testing.assert_array_equal(got, want)


def test_single_level_decode_token_identical(tiny_cfg):
    """make_greedy_decode at one noise level (no sweep axis)."""
    jmodel, params = flax_params(tiny_cfg, seed=3)
    inp = synthetic_sentences(tiny_cfg.bs, tiny_cfg.seq_len,
                              tiny_cfg.vocab_size, seed=3,
                              max_len=tiny_cfg.seq_len)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax_make_decode(jmodel, tiny_cfg)(
        params, jnp.asarray(inp), key, 0.0, 0.2))
    noise = np.asarray(jax.random.normal(
        key, (tiny_cfg.bs, tiny_cfg.seq_len, tiny_cfg.channel_dim),
        jnp.float32))
    tcfg = port_config(tiny_cfg)
    model = convert.load_into(make_model(tcfg), params).eval()
    got = make_greedy_decode(model, tcfg)(
        torch.tensor(inp, dtype=torch.long), 0.0, 0.2,
        torch.tensor(noise)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sweep_token_identical_trained_weights():
    """The committed trained transceiver (tied, d_model 128, V = 22,234) at
    B = 4 and 2 SNRs."""
    params = convert.load_params_pickle(TRAINED)
    jcfg = JaxConfig(tie_embeddings=True, dtype="float32", bs=4)
    jmodel = make_flax_model(jcfg, "transformer")
    inp = synthetic_sentences(4, jcfg.seq_len, jcfg.vocab_size, seed=3)
    want, got = _both_sweeps(jcfg, jmodel, params, inp, [3, 12], seed=5)
    np.testing.assert_array_equal(got, want)


def test_sweep_scoring_matches_jax(tiny_cfg):
    """snr_sweep_bleu_fast around fixed ids: the same table as the JAX
    package's (references and hypotheses skip <START>, mean per SNR)."""
    rng = np.random.default_rng(4)
    snrs = [0, 9, 18]
    batches = [synthetic_sentences(4, 12, 40, seed=s, max_len=12)
               for s in (0, 1)]
    outs = [np.stack([np.where(rng.random(b.shape) < 0.2 * si, 5, b)
                      for si in range(len(snrs))]) for b in batches]
    calls = iter(outs + outs)

    def fixed(*_):
        return torch.from_numpy(next(calls))

    t2i = Vocab.identity(40).token_to_idx
    want = jax_sweep_bleu(lambda *_: np.asarray(fixed()), None, batches,
                          JaxVocab(t2i), tiny_cfg, snrs=snrs)
    got = snr_sweep_bleu_fast(fixed, batches, Vocab(t2i),
                              port_config(tiny_cfg),
                              torch.Generator().manual_seed(0), snrs=snrs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-12)


def test_cli_evaluate_runs_on_cpu(tmp_path):
    res = cli.main(["evaluate", "--device", "cpu", "--bs", "4",
                    "--eval-batches", "2", "--snr-lo", "0", "--snr-hi", "2",
                    "--log-save-path", str(tmp_path), *TINY_FLAGS])
    assert [row[0] for row in res["table"]] == [0.0, 1.0, 2.0]
    assert all(0.0 <= row[1] <= 1.0 for row in res["table"])
    assert res["sequences"] == 3 * 2 * 4
    assert (tmp_path / "test-transformer-greedy.pkl").exists()


def test_cli_needs_cuda_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["evaluate", "--log-save-path", str(tmp_path),
                  *TINY_FLAGS])
