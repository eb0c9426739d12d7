"""Training-data augmentation (JAX package `data/augment.py`, numpy only,
copied so the port imports nothing of that package): the same draws from
the same seed and epoch, so both packages make bitwise-equal batches.

The system trains as an AUTOENCODER (target == input), so any well-formed
token sequence is a valid training example: the codec's job is to carry
tokens through the channel, not to model p(text). Three cheap
augmentations follow (extensions beyond the reference recipe, for the
data-limited regime):

- crop:   a random contiguous word span of an existing sentence;
- concat: the word spans of two sentences joined, truncated to the
          reference's max sentence length;
- synth:  a fresh sequence of words drawn over the FULL vocab, so every
          vocab id gets gradient signal through the channel (pair with
          `Config.tie_embeddings` so the output projection shares the
          trained rows).

All outputs keep the reference framing: <START> w1..wk <END> <PAD>*, word
counts within [min_words, max_words] (the reference's 4-30 filter), padded
to seq_len.

`load_train_dataset` loads the training set as the JAX CLI's
`_load_train_dataset` does (`deepsc_gan_tpu/cli.py:117-127`): the pickle
through `make_train_dataset`, or when it does not exist 4,096 synthetic
sentences from the seed, which ignore the `aug_*` fields.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from deepsc_gan_tpu_torch.data.loader import (
    Dataset,
    pad_sequences,
    synthetic_dataset,
)


def _strip_frame(seq: Sequence[int], start_idx: int, end_idx: int,
                 pad_idx: int) -> List[int]:
    """Token-id list -> its word ids (drop <START>/<END>/<PAD>)."""
    return [t for t in seq if t not in (start_idx, end_idx, pad_idx)]


class AugmentedDataset:
    """Shuffled batch iterator that re-draws augmentations every epoch.

    Probabilities are per-sample and mutually exclusive, applied in the
    order synth > concat > crop (remaining mass = the original sentence).
    With all probabilities 0 this is behaviorally the plain `Dataset`
    (identity pass-through of the padded originals).
    """

    def __init__(
        self,
        raw: Sequence[Sequence[int]],
        batch_size: int = 64,
        seq_len: int = 31,
        vocab_size: int = 22234,
        crop_p: float = 0.0,
        concat_p: float = 0.0,
        synth_p: float = 0.0,
        seed: int = 0,
        min_words: int = 4,
        max_words: int = 29,
        start_idx: int = 1,
        end_idx: int = 2,
        pad_idx: int = 0,
        first_word_id: int = 4,
    ):
        self.words = [
            _strip_frame(s, start_idx, end_idx, pad_idx) for s in raw
        ]
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.crop_p = crop_p
        self.concat_p = concat_p
        self.synth_p = synth_p
        self.min_words = min_words
        self.max_words = min(max_words, seq_len - 2)
        self.start_idx = start_idx
        self.end_idx = end_idx
        self.pad_idx = pad_idx
        self.first_word_id = first_word_id
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        # empirical length distribution drives synthetic lengths so the
        # pad/position statistics match the real data
        self._lens = np.clip([len(w) for w in self.words],
                             self.min_words, self.max_words)

    def __len__(self) -> int:
        return len(self.words) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffles AND augmentation draws as a pure function of
        (seed, epoch) — see loader.Dataset.set_epoch (exact-resume
        contract)."""
        self._rng = np.random.default_rng((self.seed, epoch))

    def _frame(self, words: List[int]) -> np.ndarray:
        out = np.full(self.seq_len, self.pad_idx, dtype=np.int32)
        k = min(len(words), self.max_words)
        out[0] = self.start_idx
        out[1 : 1 + k] = words[:k]
        out[1 + k] = self.end_idx
        return out

    def _sample(self, i: int) -> np.ndarray:
        rng = self._rng
        u = rng.random()
        if u < self.synth_p:
            k = int(rng.choice(self._lens))
            words = rng.integers(self.first_word_id, self.vocab_size,
                                 size=k).tolist()
            return self._frame(words)
        u -= self.synth_p
        if u < self.concat_p:
            a = self.words[rng.integers(len(self.words))]
            b = self.words[rng.integers(len(self.words))]
            return self._frame(list(a) + list(b))
        u -= self.concat_p
        words = self.words[i]
        if u < self.crop_p and len(words) > self.min_words:
            k = int(rng.integers(self.min_words, len(words)))
            off = int(rng.integers(0, len(words) - k + 1))
            return self._frame(list(words[off : off + k]))
        return self._frame(list(words))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.words))
        self._rng.shuffle(idx)
        stop = len(self.words) - len(self.words) % self.batch_size
        for i in range(0, stop, self.batch_size):
            batch = np.stack([self._sample(j) for j in idx[i : i + self.batch_size]])
            yield batch, batch


def make_train_dataset(raw, cfg, seed: int = 0):
    """Dataset factory honoring Config.aug_*: the plain shuffled `Dataset`
    when all augmentation probabilities are zero (the batches of the
    un-augmented loading), else an `AugmentedDataset`."""
    if cfg.aug_crop or cfg.aug_concat or cfg.aug_synth:
        return AugmentedDataset(
            raw, batch_size=cfg.bs, seq_len=cfg.seq_len,
            vocab_size=cfg.vocab_size, crop_p=cfg.aug_crop,
            concat_p=cfg.aug_concat, synth_p=cfg.aug_synth, seed=seed,
            start_idx=cfg.start_idx, end_idx=cfg.end_idx,
            pad_idx=cfg.pad_idx)
    return Dataset(pad_sequences(raw, maxlen=cfg.seq_len),
                   batch_size=cfg.bs, shuffle=True, seed=seed)


def load_train_dataset(cfg, seed: int = 0):
    """The training set of `cli train`: the token-list pickle at
    cfg.train_save_path through `make_train_dataset`, or 4,096 synthetic
    sentences made from `seed` when it does not exist (no augmentation
    there, as in the JAX CLI)."""
    path = cfg.train_save_path
    if os.path.exists(path):
        with open(path, "rb") as f:
            return make_train_dataset(pickle.load(f), cfg, seed=seed)
    print(f"[data] {path} not found -> synthetic dataset", file=sys.stderr)
    return synthetic_dataset(4096, cfg.seq_len, cfg.vocab_size, cfg.bs,
                             seed)
