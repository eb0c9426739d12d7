"""Test batches for the evaluation sweep (JAX package `data/loader.py` and
the CLI's fallback at `cli.py:94-114`): token-id lists from a pickle padded
post to `seq_len`, or, when the pickle is absent, synthetic sentences with
the reference's shape statistics (<START> w1..wk <END> <PAD>*)."""

from __future__ import annotations

import os
import pickle
import sys
from typing import List, Sequence

import numpy as np


def pad_sequences(seqs: Sequence[Sequence[int]], maxlen: int = 31,
                  pad_value: int = 0) -> np.ndarray:
    """Post-pad and post-truncate to (N, maxlen) int32 (keras
    `pad_sequences(..., padding='post')`)."""
    out = np.full((len(seqs), maxlen), pad_value, dtype=np.int32)
    for i, s in enumerate(seqs):
        trunc = list(s)[:maxlen]
        out[i, :len(trunc)] = trunc
    return out


def synthetic_sentences(n: int = 1024, seq_len: int = 31,
                        vocab_size: int = 22234, seed: int = 0,
                        min_len: int = 7, max_len: int = 31) -> np.ndarray:
    """(n, seq_len) int32 synthetic sentences, drawn exactly as the JAX
    package's `synthetic_dataset` draws them from the same seed."""
    rng = np.random.default_rng(seed)
    data = np.zeros((n, seq_len), dtype=np.int32)
    lens = rng.integers(min_len, max_len + 1, size=n)
    for i, length in enumerate(lens):
        length = int(min(length, seq_len))
        words = rng.integers(6, vocab_size, size=length - 2)
        data[i, 0] = 1              # <START>
        data[i, 1:length - 1] = words
        data[i, length - 1] = 2     # <END>
    return data


def eval_batches(path: str, seq_len: int, vocab_size: int, batch_size: int,
                 n_batches: int, seed: int = 0) -> List[np.ndarray]:
    """The first `n_batches` full (batch_size, seq_len) batches, in order:
    from the token-list pickle at `path`, or from 4,096 synthetic sentences
    made from `seed` when it does not exist."""
    if os.path.exists(path):
        with open(path, "rb") as f:
            data = pad_sequences(pickle.load(f), maxlen=seq_len)
    else:
        print(f"[data] {path} not found -> synthetic dataset",
              file=sys.stderr)
        data = synthetic_sentences(4096, seq_len, vocab_size, seed)
    n = min(n_batches, len(data) // batch_size)
    return [data[i * batch_size:(i + 1) * batch_size] for i in range(n)]
