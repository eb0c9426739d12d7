"""BLEU and SNR conversion (JAX package `evaluate/metrics.py:16-64`), in
pure Python with NLTK `sentence_bleu` semantics (one reference, no
smoothing): clipped n-gram precisions with a denominator of at least 1;
score 0 when no unigram matches; a zero higher-order numerator becomes the
smallest positive float (NLTK's method0); brevity penalty
exp(1 - ref_len / hyp_len) when the hypothesis is not longer. Tags like
<START> are stripped from both sides before scoring."""

from __future__ import annotations

import math
import re
import sys
from collections import Counter
from typing import List, Sequence

import numpy as np

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
    """Per-sentence BLEU with 1-4-gram weights (reference `BleuScore`)."""

    def __init__(self, w1: float, w2: float, w3: float, w4: float):
        self.weights = (w1, w2, w3, w4)

    def compute_score(self, real: Sequence[str],
                      predicted: Sequence[str]) -> List[float]:
        return [sentence_bleu(_remove_tags(r).split(),
                              _remove_tags(p).split(), self.weights)
                for r, p in zip(real, predicted)]


def SNR_to_noise(snr) -> float:
    """SNR dB -> noise std (computed in float64)."""
    return float(1.0 / np.sqrt(10.0 ** (np.asarray(snr, np.float64) / 10.0)))
