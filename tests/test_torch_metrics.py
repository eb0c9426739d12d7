"""The port's text metrics and data helpers against the JAX package's: BLEU
(NLTK semantics), SeqToText, SNR conversion, synthetic sentences and
padding."""

import re

import numpy as np
import pytest
from nltk.translate.bleu_score import sentence_bleu as nltk_sentence_bleu

from deepsc_gan_tpu.data.loader import pad_sequences as jax_pad
from deepsc_gan_tpu.data.loader import synthetic_dataset
from deepsc_gan_tpu.data.vocab import SeqToText as JaxSeqToText
from deepsc_gan_tpu.data.vocab import Vocab as JaxVocab
from deepsc_gan_tpu.evaluate.metrics import BleuScore as JaxBleuScore
from deepsc_gan_tpu.evaluate.metrics import SNR_to_noise as jax_snr
from deepsc_gan_tpu.models.channel import snr_to_noise as jax_channel_snr
from deepsc_gan_tpu_torch.data.loader import (
    eval_batches,
    pad_sequences,
    synthetic_sentences,
)
from deepsc_gan_tpu_torch.data.vocab import SeqToText, Vocab
from deepsc_gan_tpu_torch.evaluate.metrics import BleuScore, SNR_to_noise
from deepsc_gan_tpu_torch.models.channel import snr_to_noise


def _sentence_pairs(seed, n=200):
    """Seeded (reference, hypothesis) strings: edited copies, unrelated
    sentences (no overlap), hypotheses of 0-3 words, and tags."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(12)]
    pairs = []
    for i in range(n):
        ref = list(rng.choice(words, size=rng.integers(1, 25)))
        kind = i % 4
        if kind == 0:    # edited copy
            hyp = [w if rng.random() > 0.3 else str(rng.choice(words))
                   for w in ref]
        elif kind == 1:  # no overlap at all
            hyp = [f"x{j}" for j in rng.integers(0, 5, rng.integers(1, 9))]
        elif kind == 2:  # short hypothesis
            hyp = list(rng.choice(words, size=rng.integers(0, 4)))
        else:            # tags on both sides
            hyp = ["<START>"] + ref[: rng.integers(1, len(ref) + 1)]
            ref = ref + ["<END>"]
        pairs.append((" ".join(ref), " ".join(hyp)))
    return pairs


@pytest.mark.filterwarnings("ignore::UserWarning")  # NLTK on zero n-grams
@pytest.mark.parametrize("seed,weights", [(0, (1.0, 0.0, 0.0, 0.0)),
                                          (1, (0.25, 0.25, 0.25, 0.25)),
                                          (2, (0.5, 0.5, 0.0, 0.0))])
def test_bleu_matches_jax_scorer_and_nltk(seed, weights):
    pairs = _sentence_pairs(seed)
    real, pred = [r for r, _ in pairs], [h for _, h in pairs]
    got = BleuScore(*weights).compute_score(real, pred)
    want = JaxBleuScore(*weights).compute_score(real, pred)
    np.testing.assert_allclose(got, want, atol=1e-12)
    strip = lambda s: re.sub(r"<[^>]*>", "", s).split()  # noqa: E731
    nltk = [float(nltk_sentence_bleu([strip(r)], strip(h), weights=weights))
            for r, h in pairs]
    np.testing.assert_allclose(got, nltk, atol=1e-12)
    assert any(g == 0.0 for g in got) and any(0 < g < 1 for g in got)


def test_seq_to_text_matches_jax():
    rng = np.random.default_rng(1)
    t2i = {"<PAD>": 0, "<START>": 1, "<END>": 2, "<UNK>": 3}
    t2i.update({f"w{i}": i for i in range(4, 30)})
    ours, theirs = SeqToText(Vocab(t2i), 2), JaxSeqToText(JaxVocab(t2i), 2)
    for _ in range(50):
        # ids 30-34 are not in the vocab
        ids = rng.integers(0, 35, size=rng.integers(0, 20))
        assert ours.sequence_to_text(ids) == theirs.sequence_to_text(ids)


def test_snr_conversions_match_jax():
    for snr in range(-3, 25):
        assert SNR_to_noise(snr) == jax_snr(snr)
        assert snr_to_noise(snr).item() == float(jax_channel_snr(snr))


def test_synthetic_sentences_and_padding_match_jax():
    np.testing.assert_array_equal(
        synthetic_sentences(300, 32, 22234, seed=7),
        synthetic_dataset(300, 32, 22234, 64, seed=7).data)
    rng = np.random.default_rng(2)
    seqs = [list(rng.integers(1, 9, size=rng.integers(0, 40)))
            for _ in range(20)]
    np.testing.assert_array_equal(pad_sequences(seqs, 31),
                                  jax_pad(seqs, 31))


def test_eval_batches_fall_back_to_synthetic_data(tmp_path):
    batches = eval_batches(str(tmp_path / "missing.pkl"), 32, 22234, 64, 2,
                           seed=3)
    assert [b.shape for b in batches] == [(64, 32), (64, 32)]
    data = synthetic_dataset(4096, 32, 22234, 64, seed=3).data
    np.testing.assert_array_equal(np.concatenate(batches), data[:128])
