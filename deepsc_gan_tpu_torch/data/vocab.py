"""Vocabulary and id <-> text conversion (JAX package `data/vocab.py:23-112`):
the reference's vocab JSON (`{"token_to_idx": {...}}`, specials
<PAD>=0, <START>=1, <END>=2, <UNK>=3), `Vocab.build` (specials first, then
the surviving tokens in sorted order), `encode`/`decode`, and `SeqToText`
(join words up to the first <END>; unknown ids render as the string 'None',
as the reference's `dict.get`-then-join does)."""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence

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

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"token_to_idx": self.token_to_idx}, f)

    @classmethod
    def build(cls, sequences: Iterable[Sequence[str]],
              min_token_count: int = 1) -> "Vocab":
        """From tokenized sentences: the specials, then every token seen at
        least `min_token_count` times, in sorted order."""
        counts: Dict[str, int] = {}
        for toks in sequences:
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
        token_to_idx = dict(SPECIAL_TOKENS)
        for token, count in sorted(counts.items()):
            if count >= min_token_count and token not in token_to_idx:
                token_to_idx[token] = len(token_to_idx)
        return cls(token_to_idx)

    @classmethod
    def identity(cls, vocab_size: int) -> "Vocab":
        """The specials plus `w<i>` for every other id: what the CLI uses
        when no vocab file exists."""
        t2i = dict(SPECIAL_TOKENS)
        for i in range(len(SPECIAL_TOKENS), vocab_size):
            t2i[f"w{i}"] = i
        return cls(t2i)

    def __len__(self) -> int:
        return len(self.token_to_idx)

    def __contains__(self, token: str) -> bool:
        return token in self.token_to_idx

    def encode(self, tokens: Sequence[str],
               allow_unk: bool = True) -> List[int]:
        """Tokens -> ids; an unknown token is <UNK>, or a KeyError when
        `allow_unk` is False."""
        out = []
        for t in tokens:
            if t not in self.token_to_idx:
                if not allow_unk:
                    raise KeyError(f"Token {t!r} not in vocab")
                t = "<UNK>"
            out.append(self.token_to_idx[t])
        return out

    def decode(self, ids: Sequence[int], stop_at_end: bool = True,
               join: bool = False):
        """Ids -> tokens (an unknown id is <UNK>), through the first <END>
        when `stop_at_end`; one space-joined string when `join`."""
        toks: List[str] = []
        for i in ids:
            toks.append(self.idx_to_token.get(int(i), "<UNK>"))
            if stop_at_end and toks[-1] == "<END>":
                break
        return " ".join(toks) if join else toks


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
