"""The port's KV-cached greedy decoder (`evaluate/kv_decode.py`) against the
JAX package's `make_greedy_decode_kv_sweep` and the port's own full-prefix
sweep on the CPU at f32: the same weights, inputs and channel noise (the
standard normals JAX draws from the keys its sweep splits) give the same
ids, token for token. Also `cli evaluate --kv-cache`, and the two repairs
of `cli evaluate`: its test set is drawn from seed 0 whatever `--seed`, as
the JAX CLI's, and it loads the params `cli train` saved."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu import cli as jax_cli
from deepsc_gan_tpu.evaluate.kv_decode import (
    make_greedy_decode_kv_sweep as jax_make_kv_sweep,
)
from deepsc_gan_tpu.evaluate.metrics import SNR_to_noise as jax_snr_to_noise
from deepsc_gan_tpu.models.transceiver import make_model as make_flax_model
from deepsc_gan_tpu.utils.config import Config as JaxConfig
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_sentences
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_sweep
from deepsc_gan_tpu_torch.evaluate.kv_decode import (
    make_greedy_decode_kv,
    make_greedy_decode_kv_sweep,
)
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.utils import convert
from test_torch_greedy import TINY_FLAGS
from test_torch_model import TRAINED, flax_params, port_config


def _sweep_noise(key, snrs, shape):
    """n_stds and the channel normals the JAX sweep draws at each level."""
    n_stds = np.asarray([jax_snr_to_noise(s) for s in snrs], np.float32)
    noise = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                      for k in jax.random.split(key, len(snrs))])
    return n_stds, noise


def _three_sweeps(jcfg, jmodel, params, inp, snrs, seed):
    """(JAX KV ids, port KV ids, port full-prefix ids), each (S, B, T+1)."""
    key = jax.random.PRNGKey(seed)
    n_stds, noise = _sweep_noise(key, snrs, (inp.shape[0], jcfg.seq_len,
                                             jcfg.channel_dim))
    want = np.asarray(jax_make_kv_sweep(jmodel, jcfg)(
        params, jnp.asarray(inp), key, 0.0, jnp.asarray(n_stds)))
    tcfg = port_config(jcfg)
    model = convert.load_into(make_model(tcfg), params).eval()
    args = (torch.tensor(inp, dtype=torch.long), 0.0,
            torch.from_numpy(n_stds), torch.from_numpy(noise))
    kv = make_greedy_decode_kv_sweep(model, tcfg)(*args).numpy()
    full = make_greedy_decode_sweep(model, tcfg)(*args).numpy()
    return want, kv, full


@pytest.mark.parametrize("seed,tie,ffn_mode", [(0, False, "mlp"),
                                               (1, True, "mlp"),
                                               (2, False, "identity")])
def test_kv_sweep_token_identical_tiny(tiny_cfg, seed, tie, ffn_mode):
    """tiny_cfg, 4 SNRs: tied and untied projections and the identity
    FFN."""
    jcfg = tiny_cfg.replace(tie_embeddings=tie, ffn_mode=ffn_mode)
    jmodel, params = flax_params(jcfg, seed=seed)
    inp = synthetic_sentences(jcfg.bs, jcfg.seq_len, jcfg.vocab_size,
                              seed=seed, max_len=jcfg.seq_len)
    want, kv, full = _three_sweeps(jcfg, jmodel, params, inp, [0, 4, 8, 18],
                                   seed)
    assert kv.shape == (4, jcfg.bs, jcfg.max_length + 1)
    assert kv.dtype == np.int32
    np.testing.assert_array_equal(kv, want)
    np.testing.assert_array_equal(kv, full)


def test_kv_sweep_token_identical_trained_weights():
    """The committed trained transceiver (tied, full width, V = 22,234) at
    B = 2 and 2 SNRs."""
    params = convert.load_params_pickle(TRAINED)
    jcfg = JaxConfig(tie_embeddings=True, dtype="float32", bs=2)
    jmodel = make_flax_model(jcfg, "transformer")
    inp = synthetic_sentences(2, jcfg.seq_len, jcfg.vocab_size, seed=4)
    want, kv, full = _three_sweeps(jcfg, jmodel, params, inp, [2, 9], seed=6)
    np.testing.assert_array_equal(kv, want)
    np.testing.assert_array_equal(kv, full)


def test_single_level_kv_decode_equals_sweep_point(tiny_cfg):
    """make_greedy_decode_kv at one noise level gives the ids of that level
    in the sweep."""
    _, params = flax_params(tiny_cfg, seed=4)
    tcfg = port_config(tiny_cfg)
    model = convert.load_into(make_model(tcfg), params).eval()
    inp = torch.from_numpy(synthetic_sentences(4, 12, 40, seed=4,
                                               max_len=12)).long()
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn((2, 4, 12, tcfg.channel_dim), generator=gen)
    n_stds = torch.tensor([0.8, 0.2])
    swept = make_greedy_decode_kv_sweep(model, tcfg)(inp, 0.0, n_stds, noise)
    decode = make_greedy_decode_kv(model, tcfg)
    for s in range(2):
        assert torch.equal(decode(inp, 0.0, float(n_stds[s]), noise[s]),
                           swept[s])


def test_cli_evaluate_kv_cache_runs_on_cpu(tmp_path):
    res = cli.main(["evaluate", "--device", "cpu", "--kv-cache", "--bs", "4",
                    "--eval-batches", "2", "--snr-lo", "0", "--snr-hi", "2",
                    "--log-save-path", str(tmp_path), *TINY_FLAGS])
    assert [row[0] for row in res["table"]] == [0.0, 1.0, 2.0]
    assert all(0.0 <= row[1] <= 1.0 for row in res["table"])
    assert len(res["decode_seconds"]) == 2
    assert (tmp_path / "test-transformer-greedy.pkl").exists()


def test_cli_eval_set_is_seed_0_as_the_jax_cli(tmp_path, monkeypatch,
                                               tiny_cfg):
    """At --seed 3 with no test pickle, the port scores the batches the JAX
    CLI's `_load_dataset` gives (synthetic sentences from seed 0)."""
    seen = []
    real = cli.eval_batches

    def recorded(*a, **kw):
        seen.extend(real(*a, **kw))
        return seen

    monkeypatch.setattr(cli, "eval_batches", recorded)
    absent = str(tmp_path / "absent.pkl")
    cli.main(["evaluate", "--device", "cpu", "--seed", "3", "--bs", "4",
              "--eval-batches", "2", "--snr-lo", "0", "--snr-hi", "0",
              "--test-save-path", absent, "--log-save-path", str(tmp_path),
              *TINY_FLAGS])
    ds = jax_cli._load_dataset(tiny_cfg.replace(bs=4), absent, shuffle=False)
    want = [inp for inp, _ in ds][:2]
    assert len(seen) == 2
    for got, w in zip(seen, want):
        np.testing.assert_array_equal(got, np.asarray(w))


def test_cli_evaluate_loads_what_train_saved(tmp_path, capsys):
    """`cli train` (4 steps a call, one call: a training pickle of 256
    sentences) then `cli evaluate` with the same --checkpoint-path and no
    --params-pkl scores the saved params: the table of an explicit
    --params-pkl of that file."""
    ckpt = str(tmp_path / "ckpt")
    rows = synthetic_sentences(256, 12, 40, seed=1, max_len=12)
    with open(tmp_path / "train.pkl", "wb") as f:
        pickle.dump([row[row != 0].tolist() for row in rows], f)
    common = ["--device", "cpu", *TINY_FLAGS, "--bs", "64",
              "--checkpoint-path", ckpt]
    trained = cli.main(["train", *common, "--epochs", "1",
                        "--scan-steps", "4",
                        "--log-save-path", str(tmp_path / "log"),
                        "--train-save-path", str(tmp_path / "train.pkl")])
    assert (trained["steps"], trained["path"]) == (4, "scan4")
    flags = ["evaluate", *common, "--eval-batches", "1", "--snr-lo", "0",
             "--snr-hi", "1", "--log-save-path", str(tmp_path / "eval")]
    capsys.readouterr()
    res = cli.main(flags)
    assert res["params_path"] == trained["params_path"]
    assert f"params from {trained['params_path']}" in capsys.readouterr().err
    explicit = cli.main(flags + ["--params-pkl", trained["params_path"]])
    assert res["table"] == explicit["table"]
