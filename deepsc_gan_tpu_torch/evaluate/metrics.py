"""Text metrics (JAX package `evaluate/metrics.py`).

- BLEU with NLTK `sentence_bleu` semantics (one reference, no
  smoothing), by the native scorer (`native/bleu.cc`) or in pure Python:
  clipped n-gram precisions with a denominator of at least
  1; score 0 when no unigram matches; a zero higher-order numerator becomes
  the smallest positive float (NLTK's method0); brevity penalty
  exp(1 - ref_len / hyp_len) when the hypothesis is not longer. Tags like
  <START> are stripped from both sides before scoring.
- `Similarity`: BERT sentence similarity on the port's own BERT
  (`models/bert.py`, `data/wordpiece.py`) from local weights: the hidden
  state after layer `layer` summed over all `max_len` positions, pads
  included; each feature divided by its largest magnitude over the
  sentences of one `compute_score` call (so a score depends on the batch
  it is scored in); the cosine of the two sides.
- `UnigramSimilarity`: the cosine of bag-of-words counts, the stand-in
  when no BERT weights are found.
"""

from __future__ import annotations

import math
import os
import re
import sys
from collections import Counter
from typing import List, Sequence

import numpy as np
import torch

from deepsc_gan_tpu_torch import native as native_text
from deepsc_gan_tpu_torch.data.wordpiece import WordPieceTokenizer
from deepsc_gan_tpu_torch.models.bert import exact_f32_matmuls, load_bert
from deepsc_gan_tpu_torch.utils.device import resolve_device

_TAG_RE = re.compile(r"<[^>]*>")


def _remove_tags(s: str) -> str:
    return _TAG_RE.sub("", s)


def _ngrams(words: Sequence[str], n: int) -> Counter:
    return Counter(tuple(words[i:i + n]) for i in range(len(words) - n + 1))


def sentence_bleu(ref: Sequence[str], hyp: Sequence[str],
                  weights=(0.25, 0.25, 0.25, 0.25)) -> float:
    numerators, denominators = [], []
    for n in range(1, len(weights) + 1):
        hyp_counts = _ngrams(hyp, n)
        ref_counts = _ngrams(ref, n)
        numerators.append(sum(min(c, ref_counts[g])
                              for g, c in hyp_counts.items()))
        denominators.append(max(1, sum(hyp_counts.values())))
    if numerators[0] == 0:
        return 0.0
    p_n = [num / den if num else sys.float_info.min
           for num, den in zip(numerators, denominators)]
    hyp_len, ref_len = len(hyp), len(ref)
    if hyp_len > ref_len:
        bp = 1.0
    else:
        bp = math.exp(1 - ref_len / hyp_len)
    return bp * math.exp(math.fsum(w * math.log(p)
                                   for w, p in zip(weights, p_n)))


class BleuScore:
    """Per-sentence BLEU with 1-4-gram weights (reference `BleuScore`).

    With `native` (the default) the words of each call are interned to
    integer ids and scored by the C++ batch scorer (`native.bleu_batch`,
    the same semantics), as the JAX package's `BleuScore` does; where the
    library cannot be built, and with `native=False`, `sentence_bleu`."""

    def __init__(self, w1: float, w2: float, w3: float, w4: float,
                 native: bool = True):
        self.weights = (w1, w2, w3, w4)
        self.native = native

    def _compute_native(self, real, predicted) -> List[float]:
        intern: dict = {}

        def ids(sent):
            return [intern.setdefault(w, len(intern))
                    for w in _remove_tags(sent).split()]

        return native_text.bleu_batch([ids(s) for s in real],
                                      [ids(s) for s in predicted],
                                      self.weights).tolist()

    def compute_score(self, real: Sequence[str],
                      predicted: Sequence[str]) -> List[float]:
        if self.native and native_text.available():
            return self._compute_native(real, predicted)
        return [sentence_bleu(_remove_tags(r).split(),
                              _remove_tags(p).split(), self.weights)
                for r, p in zip(real, predicted)]


def SNR_to_noise(snr) -> float:
    """SNR dB -> noise std (computed in float64)."""
    return float(1.0 / np.sqrt(10.0 ** (np.asarray(snr, np.float64) / 10.0)))


def resolve_bert_path(model_path: str) -> str:
    """`model_path` as a local directory, else the snapshot of that model
    id in the local Hugging Face cache (`HF_HUB_CACHE`, else
    `HF_HOME/hub`, else ~/.cache/huggingface/hub; the revision `refs/main`
    names, else the only snapshot). Nothing is fetched: FileNotFoundError
    when neither exists."""
    if os.path.isdir(model_path):
        return model_path
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME", os.path.join(
            os.path.expanduser("~"), ".cache", "huggingface")), "hub")
    repo = os.path.join(hub, "models--" + model_path.replace("/", "--"))
    snapshots = os.path.join(repo, "snapshots")
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            candidate = os.path.join(snapshots, f.read().strip())
        if os.path.isdir(candidate):
            return candidate
    if os.path.isdir(snapshots):
        revisions = sorted(os.listdir(snapshots))
        if len(revisions) == 1:
            return os.path.join(snapshots, revisions[0])
    raise FileNotFoundError(
        f"no local BERT weights at {model_path!r} (a directory, or a "
        f"snapshot in the Hugging Face cache {hub}); nothing is downloaded")


class Similarity:
    """BERT sentence similarity from local weights (`resolve_bert_path`),
    the BERT on `device` (CUDA unless another is named), its f32 matmuls
    without TF32."""

    def __init__(self, model_path: str = "bert-base-uncased",
                 layer: int = 11, max_len: int = 32, device=None):
        directory = resolve_bert_path(model_path)
        self.device = resolve_device(device)
        self.tokenizer = WordPieceTokenizer.from_file(
            os.path.join(directory, "vocab.txt"))
        self.model = load_bert(directory, self.device)
        if not 0 <= layer < self.model.config.num_hidden_layers:
            raise ValueError(f"layer {layer}: the BERT at {directory} has "
                             f"{self.model.config.num_hidden_layers} layers")
        self.layer = layer
        self.max_len = max_len

    @torch.inference_mode()
    def embed(self, sents: Sequence[str]) -> np.ndarray:
        """-> (len(sents), hidden) f32: the hidden state after layer
        `layer`, summed over the max_len positions."""
        ids, mask = self.tokenizer.encode_batch(
            [_remove_tags(s) for s in sents], self.max_len)
        with exact_f32_matmuls():
            h = self.model(ids.to(self.device), mask.to(self.device))
        return h[self.layer + 1].sum(dim=1).cpu().numpy()

    def compute_score(self, real: Sequence[str],
                      predicted: Sequence[str]) -> List[float]:
        v1 = self.embed(real)
        v2 = self.embed(predicted)
        # each feature over its largest magnitude across this call's batch
        v1 = v1 / np.maximum(np.max(np.abs(v1), axis=0, keepdims=True), 1e-12)
        v2 = v2 / np.maximum(np.max(np.abs(v2), axis=0, keepdims=True), 1e-12)
        dot = np.sum(v1 * v2, axis=1)
        na = np.sqrt(np.sum(v1 * v1, axis=1))
        nb = np.sqrt(np.sum(v2 * v2, axis=1))
        return (dot / np.maximum(na * nb, 1e-12)).tolist()


class UnigramSimilarity:
    """The cosine of bag-of-words counts: not a reference metric, the
    stand-in where no BERT weights exist."""

    def compute_score(self, real: Sequence[str],
                      predicted: Sequence[str]) -> List[float]:
        out = []
        for a, b in zip(real, predicted):
            ta, tb = a.split(), b.split()
            vocab = set(ta) | set(tb)
            va = np.array([ta.count(w) for w in vocab], np.float64)
            vb = np.array([tb.count(w) for w in vocab], np.float64)
            denom = np.linalg.norm(va) * np.linalg.norm(vb)
            out.append(float(va @ vb / denom) if denom > 0 else 0.0)
        return out
