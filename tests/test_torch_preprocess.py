"""The port's corpus preprocessing and vocab against the JAX package's on
text the tests write: normalisation, tokenizing, the length cut and the
dedupe; `Vocab.build`/`save`/`load`/`encode`/`decode`; and the whole
pipeline, `preprocess_corpus` and `cli preprocess`, which must write the
same vocab JSON and the same pickled id lists."""

import json
import pickle
from pathlib import Path

import pytest

from deepsc_gan_tpu.data import preprocess as jax_pre
from deepsc_gan_tpu.data.vocab import Vocab as JaxVocab
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data import preprocess
from deepsc_gan_tpu_torch.data.vocab import Vocab
import test_torch_model  # noqa: F401  (one PyTorch thread per worker)

TEXTS = [
    "<speaker id='3'>Résumé of the sitting; naïve, café?</speaker>",
    "The House rose and observed a minute' s silence.",
    "Is it true?  Yes!! It is... (really)",
    "ÀÉÎÕÜ ñ ç ß æ — “quoted” text, with 42 numbers & symbols;",
    "one two three four",
    "one two three four five",
    " ".join(f"w{i}" for i in range(29)),
    " ".join(f"w{i}" for i in range(30)),
    "\ttabs\tand   spaces , before ; punctuation ?",
    "",
]


@pytest.mark.parametrize("text", TEXTS)
def test_normalize_and_tokenize_equal_jax(text):
    norm = preprocess.normalize_string(text)
    assert norm == jax_pre.normalize_string(text)
    kw = dict(punct_to_keep=preprocess.PUNCT_TO_KEEP,
              punct_to_remove=preprocess.PUNCT_TO_REMOVE)
    for start, end in ((True, True), (False, False)):
        assert preprocess.tokenize(norm, add_start_token=start,
                                   add_end_token=end, **kw) \
            == jax_pre.tokenize(norm, add_start_token=start,
                                add_end_token=end, **kw)


def test_cut_and_dedupe_equal_jax():
    lines = [jax_pre.normalize_string(t) for t in TEXTS] * 2
    assert preprocess.cutted_data(lines) == jax_pre.cutted_data(lines)
    assert preprocess.cutted_data(lines, 2, 6) \
        == jax_pre.cutted_data(lines, 2, 6)
    assert preprocess.dedupe(lines) == jax_pre.dedupe(lines)


def test_vocab_equals_jax(tmp_path):
    seqs = [["the", "cat", ";", "the"], ["a", "dog", ","], ["cat", "z"],
            ["<END>", "b"]]
    for min_count in (1, 2):
        got, want = Vocab.build(seqs, min_count), JaxVocab.build(
            seqs, min_count)
        assert got.token_to_idx == want.token_to_idx
        assert len(got) == len(want)
    got, want = Vocab.build(seqs), JaxVocab.build(seqs)
    got.save(str(tmp_path / "t.json"))
    want.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() \
        == (tmp_path / "j.json").read_bytes()
    assert Vocab.load(str(tmp_path / "j.json")).token_to_idx \
        == want.token_to_idx
    toks = ["the", "unknown", "dog", "<END>", "cat"]
    assert got.encode(toks) == want.encode(toks)
    assert ("cat" in got) and ("unknown" not in got)
    with pytest.raises(KeyError):
        got.encode(toks, allow_unk=False)
    ids = got.encode(toks) + [999]
    for stop, join in ((True, False), (False, False), (True, True)):
        assert got.decode(ids, stop, join) == want.decode(ids, stop, join)


def test_identity_vocab_equals_jax_cli_fallback(tiny_cfg):
    from deepsc_gan_tpu.cli import _load_vocab

    want = _load_vocab(tiny_cfg.replace(vocab_path="/nonexistent.json"))
    assert Vocab.identity(tiny_cfg.vocab_size).token_to_idx \
        == want.token_to_idx


def _write_corpus(root):
    corpus = root / "en"
    corpus.mkdir()
    lines = TEXTS + [f"sentence number {i} with words w{i % 7} w{i % 5} "
                     f"and more; done." for i in range(25)]
    lines += lines[:6]  # duplicates across the files
    (corpus / "b.txt").write_text("\n".join(lines[::2]), encoding="utf8")
    (corpus / "a.txt").write_text("\n".join(lines[1::2]), encoding="utf8")
    (corpus / "notes.md").write_text("ignored words here and there ok")
    return corpus


def test_preprocess_corpus_and_cli_equal_jax(tmp_path):
    corpus = _write_corpus(tmp_path)
    vocab, train, test = preprocess.preprocess_corpus(str(corpus))
    jvocab, jtrain, jtest = jax_pre.preprocess_corpus(str(corpus))
    assert vocab.token_to_idx == jvocab.token_to_idx
    assert (train, test) == (jtrain, jtest)
    assert len(train) == round(0.9 * (len(train) + len(test)))
    outs = {}
    for name, main in (("port", None), ("jax", jax_pre.main)):
        paths = [str(tmp_path / f"{name}_{f}") for f in (
            "train.pkl", "test.pkl", "vocab.json")]
        argv = ["--input-data-dir", str(corpus), "--output-train-dir",
                paths[0], "--output-test-dir", paths[1], "--output-vocab",
                paths[2]]
        if main is None:
            res = cli.main(["preprocess", "--device", "cpu", *argv])
            assert res["train"] == train
        else:
            main(argv)
        outs[name] = [Path(p).read_bytes() for p in paths]
    assert outs["port"] == outs["jax"]
    assert pickle.loads(outs["port"][0]) == jtrain
    assert json.loads(outs["port"][2]) == {"token_to_idx":
                                           jvocab.token_to_idx}
