"""The port's native text passes (`deepsc_gan_tpu_torch/native/`, its own
copies of the C++ sources built by g++ into `_build/`) against its Python
path and against the JAX package's native library on the same inputs:
the normalization cases and a fuzz of tests/test_native.py,
`pad_sequences`, BLEU against the Python `sentence_bleu`, and `BleuScore`
and `process_file` with and without the native path."""

import random
import string

import numpy as np
import pytest

from deepsc_gan_tpu import native as jax_native
from deepsc_gan_tpu_torch import native
from deepsc_gan_tpu_torch.data import preprocess
from deepsc_gan_tpu_torch.data.loader import pad_sequences
from deepsc_gan_tpu_torch.evaluate.metrics import BleuScore, sentence_bleu

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="no C++ toolchain")

CASES = [
    "Hello, World!", "<P>Tagged</P> text.", "café résumé naïve Müller",
    "nums 123 stay out", "", "   ", "####", "a.b", "a..b!c?d", ".leading",
    "trailing.", "un<closed tag", "<a href='x.y'>link</a> done",
    "tabs\tand\nnewlines", "MiXeD CaSe", "ümlaut at start",
    "dash-joined words", "it's apostrophes",
    "resumption of the session <SPEAKER ID=1> I declare...",
]


def _fuzz(n, seed):
    rng = random.Random(seed)
    alphabet = (string.ascii_letters + string.digits + " .!?,;<>()'\"-"
                + "éàüßñç\t")
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 80)))
            for _ in range(n)]


def test_library_builds_under_the_port_build_directory():
    path = native.build()
    assert path.exists() and path.parent.parent == native.BUILD_DIR
    assert path.parent.name.startswith("native-")


@pytest.mark.parametrize("s", CASES)
def test_normalize_string_matches_python_and_jax(s):
    got = native.normalize_string(s)
    assert got == preprocess.normalize_string(s), repr(s)
    assert got == jax_native.normalize_string(s), repr(s)


@pytest.mark.parametrize("seed", [0, 1])
def test_normalize_lines_fuzz_matches_python_and_jax(seed):
    lines = CASES + _fuzz(300, seed)
    got = native.normalize_lines(lines)
    assert got == [preprocess.normalize_string(s) for s in lines]
    assert got == jax_native.normalize_lines(lines)


def test_pad_sequences_matches_python_and_jax():
    rng = np.random.default_rng(0)
    seqs = [[1, 2], [3, 4, 5, 6, 7], [], [9] * 40] + [
        rng.integers(0, 22234, int(rng.integers(0, 45))).tolist()
        for _ in range(64)]
    for maxlen, pad in ((31, 0), (12, 7)):
        got = native.pad_sequences(seqs, maxlen, pad)
        np.testing.assert_array_equal(
            got, pad_sequences(seqs, maxlen, pad, native=False))
        np.testing.assert_array_equal(
            got, jax_native.pad_sequences(seqs, maxlen, pad))
        np.testing.assert_array_equal(
            pad_sequences(seqs, maxlen, pad), got)


def _pairs(seed, n=120):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rlen, hlen = int(rng.integers(1, 32)), int(rng.integers(0, 32))
        vocab = int(rng.integers(3, 30))
        ref = rng.integers(0, vocab, rlen).tolist()
        if rng.random() < 0.5 and hlen:
            hyp = [ref[int(rng.integers(0, rlen))] for _ in range(hlen)]
        else:
            hyp = rng.integers(0, vocab, hlen).tolist()
        out.append((ref, hyp))
    return out + [([1, 2, 3], [1, 2, 3]), ([1, 2, 3], []), ([5], [7]),
                  ([1, 1, 1, 1], [1, 1]), ([1, 2], [1, 2, 3, 4, 5])]


@pytest.mark.parametrize("weights", [(1.0, 0.0, 0.0, 0.0),
                                     (0.25, 0.25, 0.25, 0.25),
                                     (0.5, 0.5, 0.0, 0.0),
                                     (0.0, 0.0, 0.0, 1.0)])
def test_bleu_batch_matches_python_and_jax(weights):
    pairs = _pairs(0)
    refs, hyps = [p[0] for p in pairs], [p[1] for p in pairs]
    got = native.bleu_batch(refs, hyps, weights)
    want = [sentence_bleu([str(t) for t in r], [str(t) for t in h], weights)
            for r, h in pairs]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(got, jax_native.bleu_batch(refs, hyps,
                                                             weights))


def test_bleuscore_native_and_python_paths_agree():
    real = ["the cat sat on the mat", "hello world", "a b c d",
            "<START> w5 w6 w7 <END>"]
    pred = ["the cat sat on mat", "hello there world", "a b x d",
            "w5 w7 w6"]
    for weights in ((1, 0, 0, 0), (0.25, 0.25, 0.25, 0.25)):
        fast = BleuScore(*weights, native=True).compute_score(real, pred)
        slow = BleuScore(*weights, native=False).compute_score(real, pred)
        np.testing.assert_allclose(fast, slow, rtol=1e-12)


def test_process_file_native_and_python_paths_agree(tmp_path):
    path = tmp_path / "corpus.txt"
    lines = CASES + _fuzz(200, 2) + [
        "this sentence has exactly enough words to be kept ok",
        "Café au lait, s'il vous plaît! — a longer line of words here."]
    path.write_text("\n".join(lines), encoding="utf8")
    got = preprocess.process_file(str(path))
    assert got == preprocess.process_file(str(path), native=False)
    assert len(got) > 0


def test_a_missing_compiler_leaves_the_python_path(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "no g++")
    assert not native.available()
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        native.normalize_string("x")
    real, pred = ["a b c"], ["a b"]
    assert BleuScore(1, 0, 0, 0).compute_score(real, pred) == \
        BleuScore(1, 0, 0, 0, native=False).compute_score(real, pred)
