"""The sentence-similarity metric of the port on tiny random BERT
checkpoints the tests write (as the JAX package's own tests do): the
WordPiece tokenizer against `transformers.BertTokenizer`, the port's BERT
against `transformers.BertModel` (eager attention) at f32 within 1e-5 for
every hidden state, both weight files (safetensors and
pytorch_model.bin), `Similarity` within 1e-5 of the JAX package's,
`UnigramSimilarity`, `make_scorers`, the sweeps' metric columns against
the JAX package's, and `cli evaluate --metric both`."""

import numpy as np
import pytest
import torch
from transformers import BertConfig as HFBertConfig
from transformers import BertModel, BertTokenizer

from deepsc_gan_tpu.data.vocab import Vocab as JaxVocab
from deepsc_gan_tpu.evaluate import evaluator as jax_evaluator
from deepsc_gan_tpu.evaluate.metrics import Similarity as JaxSimilarity
from deepsc_gan_tpu.evaluate.metrics import (
    UnigramSimilarity as JaxUnigramSimilarity,
)
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import synthetic_sentences
from deepsc_gan_tpu_torch.data.vocab import Vocab
from deepsc_gan_tpu_torch.data.wordpiece import WordPieceTokenizer
from deepsc_gan_tpu_torch.evaluate import evaluator, metrics
from deepsc_gan_tpu_torch.models.bert import (
    BertConfig,
    load_bert,
    read_safetensors,
    write_safetensors,
)
from test_torch_greedy import TINY_FLAGS
from test_torch_model import port_config

ATOL = 1e-5
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat", "sat",
         "on", "mat", "a", "dog", "ran", "fast", "hello", "world", "un",
         "##believ", "##able", "##s", "cafe", "resume", ",", ".", "!", "?",
         "'", "中", "naive"] + [f"w{i}" for i in range(4, 40)]


def _tiny_bert(directory, safe=True, seed=0, layers=12):
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "vocab.txt").write_text("\n".join(WORDS) + "\n")
    config = HFBertConfig(
        vocab_size=len(WORDS) + 3, hidden_size=16, num_hidden_layers=layers,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=40, layer_norm_eps=1e-7,
        attn_implementation="eager")
    torch.manual_seed(seed)
    model = BertModel(config).eval()
    with torch.no_grad():  # LayerNorms and biases away from 1 and 0
        for p in model.parameters():
            p.add_(0.1 * torch.randn_like(p))
    model.save_pretrained(str(directory), safe_serialization=safe)
    BertTokenizer(str(directory / "vocab.txt")).save_pretrained(
        str(directory))
    return model


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_bert")
    _tiny_bert(d)
    return str(d)


TEXTS = ["The Cat sat on the mat.", "unbelievable cats!",
         "Café naïve, résumé?", "hello\tworld\x00 ​ ok", "中国 dog",
         "x" * 120 + " dog", "a [SEP] b [cls] c [MASK]", "w12 w4 w5 W12 w39",
         "", "the " * 40, "don't stop", "hello[MASK]world", "w7, w8; w9!"]


@pytest.mark.parametrize("max_len", [8, 32])
def test_wordpiece_equals_bert_tokenizer(tmp_path, max_len):
    (tmp_path / "vocab.txt").write_text("\n".join(WORDS) + "\n")
    ref = BertTokenizer(str(tmp_path / "vocab.txt"))
    mine = WordPieceTokenizer.from_file(str(tmp_path / "vocab.txt"))
    for t in TEXTS:
        assert mine.tokenize(t) == ref.tokenize(t), t
    want = ref(TEXTS, padding="max_length", truncation=True,
               max_length=max_len, return_tensors="pt")
    ids, mask = mine.encode_batch(TEXTS, max_len)
    assert torch.equal(ids, want["input_ids"])
    assert torch.equal(mask, want["attention_mask"])


@pytest.mark.parametrize("safe", [True, False])
def test_bert_hidden_states_equal_transformers(tmp_path, safe):
    """Every hidden state within 1e-5 of BertModel's, from model.safetensors
    or pytorch_model.bin, with pads in the mask."""
    ref = _tiny_bert(tmp_path, safe=safe, seed=1, layers=3)
    assert (tmp_path / ("model.safetensors" if safe
                        else "pytorch_model.bin")).exists()
    model = load_bert(str(tmp_path))
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, len(WORDS), (3, 11), generator=g)
    mask = torch.ones_like(ids)
    mask[1, 6:] = 0
    mask[2, 2:] = 0
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask,
                   output_hidden_states=True).hidden_states
    got = model(ids, mask)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)


def test_safetensors_round_trip_and_prefix(tmp_path):
    """write_safetensors/read_safetensors in F32, F16 and BF16; a `bert.`
    prefix and a pooler are accepted by the loader."""
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 4, generator=g),
               "b": torch.randn(5, generator=g).half(),
               "c": torch.randn(2, 2, generator=g).bfloat16()}
    write_safetensors(str(tmp_path / "t.safetensors"), tensors)
    back = read_safetensors(str(tmp_path / "t.safetensors"))
    assert sorted(back) == sorted(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    src = tmp_path / "src"
    ref = _tiny_bert(src, seed=3, layers=2)
    state = {"bert." + k: v for k, v in ref.state_dict().items()}
    state["cls.predictions.bias"] = torch.zeros(3)
    d = tmp_path / "prefixed"
    d.mkdir()
    (d / "config.json").write_text((src / "config.json").read_text())
    write_safetensors(str(d / "model.safetensors"), state)
    model = load_bert(str(d))
    ids = torch.randint(0, len(WORDS), (2, 7), generator=g)
    with torch.no_grad():
        want = ref(input_ids=ids, output_hidden_states=True).hidden_states
    assert torch.allclose(model(ids)[-1], want[-1], atol=ATOL, rtol=0)
    assert BertConfig.from_json(str(d / "config.json")).layer_norm_eps \
        == 1e-7


SENTS = (["the cat sat on mat", "a dog ran fast", "hello world",
          "w5 w6 w7 w8", "unbelievable naive cafe"],
         ["hello world", "the mat sat", "a cat ran", "w5 w9 w7",
          "unbelievable naive cafe"])


def test_similarity_equals_jax(bert_dir):
    got = metrics.Similarity(bert_dir, max_len=16, device="cpu")
    want = JaxSimilarity(model_path=bert_dir, max_len=16)
    np.testing.assert_allclose(got.compute_score(*SENTS),
                               want.compute_score(*SENTS), atol=ATOL,
                               rtol=0)
    same = got.compute_score(SENTS[0], SENTS[0])
    np.testing.assert_allclose(same, 1.0, atol=ATOL)
    with pytest.raises(ValueError, match="layers"):
        metrics.Similarity(bert_dir, layer=12, device="cpu")


def test_unigram_similarity_equals_jax():
    a, b = SENTS[0] + ["", "x y"], SENTS[1] + ["x", ""]
    assert metrics.UnigramSimilarity().compute_score(a, b) \
        == JaxUnigramSimilarity().compute_score(a, b)


def test_make_scorers(bert_dir, monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("DEEPSC_BERT_PATH", str(tmp_path / "absent"))
    names = [(n, type(s).__name__) for n, s in evaluator.make_scorers(
        "both", device="cpu")]
    assert names == [("bleu", "BleuScore"),
                     ("similarity", "UnigramSimilarity")]
    assert "unigram-cosine fallback" in capsys.readouterr().err
    monkeypatch.setenv("DEEPSC_BERT_PATH", bert_dir)
    (name, scorer), = evaluator.make_scorers("similarity", device="cpu")
    assert isinstance(scorer, metrics.Similarity)
    assert capsys.readouterr().err == ""
    with pytest.raises(ValueError, match="metric"):
        evaluator.make_scorers("rouge")


def test_resolve_bert_path_reads_the_hf_cache(tmp_path, monkeypatch):
    snap = tmp_path / "hub" / "models--org--tiny" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    refs = tmp_path / "hub" / "models--org--tiny" / "refs"
    refs.mkdir()
    (refs / "main").write_text("abc\n")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert metrics.resolve_bert_path("org/tiny") == str(snap)
    with pytest.raises(FileNotFoundError):
        metrics.resolve_bert_path("org/other")


@pytest.mark.parametrize("fast", [True, False])
def test_sweep_metric_columns_equal_jax(tiny_cfg, bert_dir, monkeypatch,
                                        fast):
    """--metric both around fixed ids: the same [snr, BLEU, similarity]
    rows as the JAX package's sweeps (one scorer call per SNR and batch)."""
    monkeypatch.setenv("DEEPSC_BERT_PATH", bert_dir)
    rng = np.random.default_rng(4)
    snrs = [0, 9, 18]
    batches = [synthetic_sentences(4, 12, 40, seed=s, max_len=12)
               for s in (0, 1)]
    t2i = Vocab.identity(40).token_to_idx
    if fast:
        outs = [np.stack([np.where(rng.random(b.shape) < 0.2 * si, 5, b)
                          for si in range(len(snrs))]) for b in batches]
    else:
        outs = [np.where(rng.random(b.shape) < 0.1 * si, 7, b)
                for si in range(len(snrs)) for b in batches]
    calls = iter(outs + outs)

    def fixed(*_):
        return torch.from_numpy(next(calls))

    sweep = (jax_evaluator.snr_sweep_bleu_fast if fast
             else jax_evaluator.snr_sweep_bleu)
    want = sweep(lambda *_: np.asarray(fixed()), None, batches,
                 JaxVocab(t2i), tiny_cfg, snrs=snrs, metric="both")
    sweep = (evaluator.snr_sweep_bleu_fast if fast
             else evaluator.snr_sweep_bleu)
    got = sweep(fixed, batches, Vocab(t2i), port_config(tiny_cfg),
                torch.Generator().manual_seed(0), snrs=snrs, metric="both")
    assert np.asarray(got).shape == (3, 3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("mode", ["greedy", "teacher_forced"])
def test_cli_evaluate_metric_both(tmp_path, bert_dir, monkeypatch, mode):
    """BLEU columns identical to the BLEU-only run's, the similarity columns
    the means of the port's scorer over the calls, JAX's layout: [snr,
    BLEU, similarity] or [snr, clean BLEU, clean similarity, attacked BLEU,
    attacked similarity, loss clean, loss attacked]."""
    argv = ["evaluate", "--device", "cpu", "--bs", "4", "--eval-batches",
            "2", "--snr-lo", "0", "--snr-hi", "1", "--eval-mode", mode,
            "--log-save-path", str(tmp_path), *TINY_FLAGS]
    bleu = cli.main(argv)["table"]
    monkeypatch.setenv("DEEPSC_BERT_PATH", bert_dir)
    calls = []
    score = metrics.Similarity.compute_score

    def recording(self, real, predicted):
        out = score(self, real, predicted)
        calls.append(out)
        return out

    monkeypatch.setattr(metrics.Similarity, "compute_score", recording)
    both = np.asarray(cli.main(argv + ["--metric", "both"])["table"])
    bleu = np.asarray(bleu)
    if mode == "greedy":
        assert both.shape == (2, 3)
        assert np.array_equal(both[:, :2], bleu)
        # batch-major calls: every SNR point of a batch, batch by batch
        sims = [np.mean(calls[si] + calls[2 + si]) for si in range(2)]
        np.testing.assert_allclose(both[:, 2], sims, atol=1e-12, rtol=0)
    else:
        assert both.shape == (2, 7)
        assert np.array_equal(both[:, [0, 1, 3, 5, 6]], bleu)
        # per SNR and batch: the clean call, then the attacked one
        for si in range(2):
            c = calls[4 * si:4 * si + 4]
            np.testing.assert_allclose(
                both[si, [2, 4]], [np.mean(c[0] + c[2]),
                                   np.mean(c[1] + c[3])], atol=1e-12,
                rtol=0)
