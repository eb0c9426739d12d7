"""The FGM-robust trained weights through the port on the CPU at f32,
against the JAX package: `results/robust_params.pkl` (the transformer
fine-tuned with FGM by scripts/robust_tables.py) and
`results/star_robust_params.pkl` (the star transceiver, by
scripts/star_robust.py). On one small batch, the greedy sweep (the star's
one-shot sweep) and the FGM-attacked greedy decode through AWGN give
token-identical ids, both sides fed the same channel draws. Each JAX
function is compiled once."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.evaluate.greedy import (
    make_greedy_decode_attack as jax_greedy_attack,
)
from deepsc_gan_tpu.models.transceiver import make_model as make_flax_model
from deepsc_gan_tpu.utils.config import Config as JaxConfig
from deepsc_gan_tpu_torch.data.loader import synthetic_sentences
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_attack
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.utils import convert
from test_torch_attacks import PNR_DB, _channel_draw
from test_torch_greedy import _both_sweeps
from test_torch_model import port_config
from test_torch_train import N_STD

RESULTS = Path(__file__).resolve().parent.parent / "results"
# the config both files were trained with: scripts/robust_tables.py:66-73
# (LEVERS) and :129 (dropout 0.2), which scripts/star_robust.py:121 reuses;
# here at batch 4 and f32
TRAINED = dict(tie_embeddings=True, label_smoothing=0.1, aug_crop=0.2,
               aug_concat=0.2, aug_synth=0.3, train_snr_random=True,
               schedule="cosine", decay_steps=120000, seq_len=31,
               encoder_dropout=0.2, decoder_dropout=0.2, dtype="float32",
               bs=4)
# variant -> (weights, the decode's position mode)
WEIGHTS = {"transformer": ("robust_params.pkl", "step"),
           "star": ("star_robust_params.pkl", "oneshot")}


@pytest.fixture(scope="module")
def robust():
    missing = [name for name, _ in WEIGHTS.values()
               if not (RESULTS / name).exists()]
    if missing:
        pytest.skip(f"{', '.join(missing)} not in this checkout")
    return {variant: convert.load_params_pickle(str(RESULTS / name))
            for variant, (name, _) in WEIGHTS.items()}


def _inputs(jcfg):
    return synthetic_sentences(jcfg.bs, jcfg.seq_len, jcfg.vocab_size,
                               seed=3)


@pytest.mark.parametrize("variant", list(WEIGHTS))
def test_robust_weights_greedy_sweep_token_identical(robust, variant):
    """The clean greedy sweep at 0 and 12 dB (the star's one-shot), and a
    model that decodes: most ids at 12 dB are not <PAD>."""
    jcfg = JaxConfig(**TRAINED)
    want, got = _both_sweeps(jcfg, make_flax_model(jcfg, variant),
                             robust[variant], _inputs(jcfg), [0, 12], 5,
                             variant, WEIGHTS[variant][1])
    np.testing.assert_array_equal(got, want)
    assert (got[1] != 0).mean() > 0.5


@pytest.mark.parametrize("variant", list(WEIGHTS))
def test_robust_weights_attacked_decode_token_identical(robust, variant):
    """The FGM-attacked greedy decode (epsilon 1, AWGN; the star scores the
    un-shifted target), the same two draws on both sides: the gradient's
    channel and the decode's."""
    star = variant != "transformer"
    mode = WEIGHTS[variant][1]
    jcfg = JaxConfig(**TRAINED)
    params = robust[variant]
    key = jax.random.PRNGKey(51)
    inp = _inputs(jcfg)
    want = np.asarray(jax_greedy_attack(
        make_flax_model(jcfg, variant), jcfg, position_mode=mode,
        full_target=star)(params, jnp.asarray(inp), key, PNR_DB, N_STD,
                          1.0))
    noise = torch.stack([_channel_draw(k, jcfg, "AWGN")[0]
                         for k in jax.random.split(key)])
    tcfg = port_config(jcfg)
    model = convert.load_into(make_model(tcfg, variant), params).eval()
    got = make_greedy_decode_attack(model, tcfg, position_mode=mode,
                                    full_target=star)(
        torch.from_numpy(inp).long(), PNR_DB, N_STD, noise, None, 1.0)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
