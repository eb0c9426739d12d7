"""The port's one-shot BLEU-vs-SNR sweep of the star transceivers against
the JAX package's `make_greedy_decode_sweep(position_mode="oneshot")` on
the CPU at f32: the same weights, inputs and channel noise give
token-identical ids, on tiny_cfg (star and star_multi, tied and untied, and
the "last" mode) and on the committed star weights. Also the star paths of
the CLI."""

from pathlib import Path

import numpy as np
import pytest

from deepsc_gan_tpu.utils.config import Config as JaxConfig
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_sentences
from deepsc_gan_tpu_torch.evaluate import greedy
from deepsc_gan_tpu_torch.utils import convert
from test_torch_greedy import TINY_FLAGS, _both_sweeps
from test_torch_star import star_params

STAR_TRAINED = str(Path(__file__).resolve().parent.parent / "results"
                   / "star_best_params.pkl")
STAR_FLAGS = [*TINY_FLAGS, "--cycle-num", "2"]
# (variant, tied, position mode, seed)
SWEEPS = {"star-untied": ("star", False, "oneshot", 0),
          "star-tied": ("star", True, "oneshot", 1),
          "star_multi-untied": ("star_multi", False, "oneshot", 2),
          "star_multi-tied": ("star_multi", True, "oneshot", 3),
          "star-last": ("star", False, "last", 4)}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_star_sweep_token_identical_tiny(tiny_cfg, case):
    variant, tie, mode, seed = SWEEPS[case]
    jcfg = tiny_cfg.replace(tie_embeddings=tie)
    jmodel, params = star_params(jcfg, seed, variant)
    inp = synthetic_sentences(jcfg.bs, jcfg.seq_len, jcfg.vocab_size,
                              seed=seed, max_len=jcfg.seq_len)
    want, got = _both_sweeps(jcfg, jmodel, params, inp, [0, 6, 18], seed,
                             variant, mode)
    assert want.shape == (3, jcfg.bs, jcfg.max_length + 1)
    np.testing.assert_array_equal(got, want)


def test_star_sweep_token_identical_trained_weights():
    """The committed single-block star weights (tied, d_model 128,
    V = 22,234, 8 cycles, seq_len 31): 8 sentences at 3 SNRs."""
    if not Path(STAR_TRAINED).exists():
        pytest.skip(f"{STAR_TRAINED} is not in this checkout")
    from deepsc_gan_tpu.models.transceiver import make_model as make_flax

    params = convert.load_params_pickle(STAR_TRAINED)
    jcfg = JaxConfig(tie_embeddings=True, dtype="float32", bs=8, seq_len=31)
    inp = synthetic_sentences(8, 31, jcfg.vocab_size, seed=3)
    want, got = _both_sweeps(jcfg, make_flax(jcfg, "star"), params, inp,
                             [0, 6, 12], 5, "star", "oneshot")
    np.testing.assert_array_equal(got, want)
    # a model that decodes at all: most ids at 12 dB are not <PAD>
    assert (got[2] != 0).mean() > 0.5


def test_unknown_position_mode_raises(tiny_cfg):
    with pytest.raises(ValueError, match="position_mode"):
        greedy._decode_loop(None, None, None, 3, 1, 0, "first")


@pytest.mark.parametrize("variant,seq_len", [("star", 31), ("star_multi", 31),
                                             ("transformer", 32)])
def test_seq_len_resolves_per_variant(variant, seq_len):
    for cmd in ("evaluate", "train"):
        args = cli.build_parser().parse_args([cmd, "--variant", variant])
        assert cli.variant_config(args).seq_len == seq_len
    args = cli.build_parser().parse_args(["train", "--variant", variant,
                                          "--seq-len", "12"])
    assert cli.variant_config(args).seq_len == 12


def test_cli_star_evaluate_and_kv_cache_run_one_shot(tmp_path, monkeypatch):
    """`evaluate --variant star` on the CPU; with --kv-cache it runs the
    same one-shot sweep (the KV decoder is never built)."""
    flags = ["evaluate", "--variant", "star", "--device", "cpu", "--bs", "4",
             "--eval-batches", "2", "--snr-lo", "0", "--snr-hi", "2",
             "--log-save-path", str(tmp_path), *STAR_FLAGS]
    res = cli.main(flags)
    assert [row[0] for row in res["table"]] == [0.0, 1.0, 2.0]
    assert all(0.0 <= row[1] <= 1.0 for row in res["table"])
    assert (tmp_path / "test-star-greedy.pkl").exists()

    def refuse(*_):
        raise AssertionError("the KV decoder was built for a star variant")

    monkeypatch.setattr(cli, "make_greedy_decode_kv_sweep", refuse)
    assert cli.main([*flags, "--kv-cache"])["table"] == res["table"]


def test_cli_star_beam_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="non-autoregressive"):
        cli.main(["evaluate", "--variant", "star", "--eval-mode", "beam",
                  "--device", "cpu", "--log-save-path", str(tmp_path),
                  *STAR_FLAGS])
