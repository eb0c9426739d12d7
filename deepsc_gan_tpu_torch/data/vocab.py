"""Vocabulary and id -> text conversion (JAX package `data/vocab.py:23-112`):
the reference's vocab JSON (`{"token_to_idx": {...}}`, specials
<PAD>=0, <START>=1, <END>=2, <UNK>=3) and `SeqToText` (join words up to the
first <END>; unknown ids render as the string 'None', as the reference's
`dict.get`-then-join does)."""

from __future__ import annotations

import json
from typing import Dict, Sequence

SPECIAL_TOKENS = {"<PAD>": 0, "<START>": 1, "<END>": 2, "<UNK>": 3}


class Vocab:
    def __init__(self, token_to_idx: Dict[str, int]):
        self.token_to_idx = dict(token_to_idx)
        self.idx_to_token = {i: t for t, i in self.token_to_idx.items()}

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as f:
            blob = json.load(f)
        # the reference wrapper {"token_to_idx": {...}} or a bare mapping
        return cls(blob.get("token_to_idx", blob))

    @classmethod
    def identity(cls, vocab_size: int) -> "Vocab":
        """The specials plus `w<i>` for every other id: what the CLI uses
        when no vocab file exists."""
        t2i = dict(SPECIAL_TOKENS)
        for i in range(len(SPECIAL_TOKENS), vocab_size):
            t2i[f"w{i}"] = i
        return cls(t2i)


class SeqToText:
    def __init__(self, vocab: Vocab, end_idx: int = 2):
        self.reverse_word_map = vocab.idx_to_token
        self.end_idx = end_idx

    def sequence_to_text(self, list_of_indices: Sequence[int]) -> str:
        words = []
        for idx in list_of_indices:
            idx = int(idx)
            if idx == self.end_idx:
                break
            words.append(str(self.reverse_word_map.get(idx)))
        return " ".join(words)
