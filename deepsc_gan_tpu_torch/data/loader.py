"""Batches for the evaluation sweep and for training (JAX package
`data/loader.py` and the CLI's fallbacks at `cli.py:94-126`): token-id
lists from a pickle padded post to `seq_len`, or, when the pickle is
absent, synthetic sentences with the reference's shape statistics
(<START> w1..wk <END> <PAD>*)."""

from __future__ import annotations

import os
import pickle
import sys
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from deepsc_gan_tpu_torch import native as native_text


def pad_sequences(seqs: Sequence[Sequence[int]], maxlen: int = 31,
                  pad_value: int = 0, native: bool = True) -> np.ndarray:
    """Post-pad and post-truncate to (N, maxlen) int32 (keras
    `pad_sequences(..., padding='post')`), by the native pass
    (`native.pad_sequences`) when `native` and the library builds."""
    if native and native_text.available():
        return native_text.pad_sequences(seqs, maxlen, pad_value)
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


def load_sentences(path: str, seq_len: int, vocab_size: int,
                   seed: int = 0) -> np.ndarray:
    """(N, seq_len) int32: the token-list pickle at `path` padded, or 4,096
    synthetic sentences made from `seed` when it does not exist."""
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pad_sequences(pickle.load(f), maxlen=seq_len)
    print(f"[data] {path} not found -> synthetic dataset", file=sys.stderr)
    return synthetic_sentences(4096, seq_len, vocab_size, seed)


def eval_batches(path: str, seq_len: int, vocab_size: int, batch_size: int,
                 n_batches: int, seed: int = 0) -> List[np.ndarray]:
    """The first `n_batches` full (batch_size, seq_len) batches of
    `load_sentences`, in order."""
    data = load_sentences(path, seq_len, vocab_size, seed)
    n = min(n_batches, len(data) // batch_size)
    return [data[i * batch_size:(i + 1) * batch_size] for i in range(n)]


class Dataset:
    """Shuffled, fixed-shape batch iterator over padded sentences (JAX
    package `data/loader.py:Dataset`): the same numpy shuffle from the same
    seed, so both packages draw the same batches in the same order. Yields
    (inp, tar) with tar == inp (the system is an autoencoder)."""

    def __init__(self, data: np.ndarray, batch_size: int = 64,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True):
        if data.ndim != 2:
            raise ValueError(f"data must be (N, L), not {data.shape}")
        self.data = np.asarray(data, dtype=np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle as a pure function of (seed, epoch)."""
        self._rng = np.random.default_rng((self.seed, epoch))

    def __len__(self) -> int:
        n = len(self.data) // self.batch_size
        if not self.drop_remainder and len(self.data) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.data))
        if self.shuffle:
            self._rng.shuffle(idx)
        stop = len(self.data) - (len(self.data) % self.batch_size
                                 if self.drop_remainder else 0)
        for i in range(0, stop, self.batch_size):
            batch = self.data[idx[i:i + self.batch_size]]
            yield batch, batch


def stacked_batches(ds, k: int) -> Iterator[np.ndarray]:
    """Endless (k, B, L) stacks of `ds`'s input batches for the multi-step
    train path (`train/steps.py:make_train_multi_step`; JAX package
    `data/loader.py:stacked_batches`), buffering across epoch boundaries
    so no batch is dropped when len(ds) % k != 0. Each pass over `ds` is
    one of its epochs (its shuffle as it stands when the pass starts)."""
    buf: List[np.ndarray] = []
    while True:
        for inp, _ in ds:
            buf.append(inp)
            if len(buf) == k:
                yield np.stack(buf)
                buf = []


def synthetic_dataset(n: int = 1024, seq_len: int = 31,
                      vocab_size: int = 22234, batch_size: int = 64,
                      seed: int = 0, min_len: int = 7,
                      max_len: int = 31) -> Dataset:
    """`synthetic_sentences` as a shuffled Dataset (JAX package
    `synthetic_dataset`)."""
    return Dataset(synthetic_sentences(n, seq_len, vocab_size, seed, min_len,
                                       max_len),
                   batch_size=batch_size, seed=seed)
