"""The BERT uncased tokenizer (what `transformers.BertTokenizer` computes
with its defaults), for the sentence-similarity metric.

- The text is split at the special tokens ([PAD], [UNK], [CLS], [SEP],
  [MASK]), which map to their ids as they stand.
- The basic pass on the rest: control characters dropped and whitespace
  made a space; spaces around CJK characters; NFC; whitespace split; each
  token lower-cased and its accents stripped (NFD, marks dropped); every
  punctuation character its own token.
- WordPiece: greedy longest match first, continuations prefixed `##`; a
  word with no match, or of more than 100 characters, is [UNK].
- `encode_batch`: [CLS] tokens [SEP], truncated to `max_len`, padded with
  [PAD] to `max_len`, with the attention mask.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import torch

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
MAX_WORD_CHARS = 100


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 \
            or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _clean(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out.append(" " if _is_whitespace(ch) else ch)
    return "".join(out)


def _split_punctuation(token: str) -> List[str]:
    out: List[List[str]] = []
    new_word = True
    for ch in token:
        if _is_punctuation(ch):
            out.append([ch])
            new_word = True
        else:
            if new_word:
                out.append([])
            new_word = False
            out[-1].append(ch)
    return ["".join(x) for x in out]


def _strip_accents(token: str) -> str:
    return "".join(ch for ch in unicodedata.normalize("NFD", token)
                   if unicodedata.category(ch) != "Mn")


def basic_tokenize(text: str) -> List[str]:
    """The basic pass of an uncased BERT tokenizer."""
    text = _clean(text)
    text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)
    text = unicodedata.normalize("NFC", text)
    split = []
    for token in text.split():
        split.extend(_split_punctuation(_strip_accents(token.lower())))
    return " ".join(split).split()


class WordPieceTokenizer:
    """From a `vocab.txt` (one token a line; the id is the line number)."""

    def __init__(self, vocab: Dict[str, int]):
        self.vocab = vocab
        missing = [t for t in SPECIALS if t not in vocab]
        if missing:
            raise ValueError(f"vocab lacks the special tokens {missing}")
        self._special_re = re.compile(
            "(" + "|".join(re.escape(t) for t in SPECIALS) + ")")

    @classmethod
    def from_file(cls, path: str) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab)

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > MAX_WORD_CHARS:
            return ["[UNK]"]
        pieces, start = [], 0
        while start < len(word):
            end, piece = len(word), None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return ["[UNK]"]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        for part in self._special_re.split(text):
            if part in SPECIALS:
                tokens.append(part)
            else:
                for word in basic_tokenize(part):
                    tokens.extend(self._wordpiece(word))
        return tokens

    def encode(self, text: str, max_len: int) -> List[int]:
        """[CLS] ids [SEP], the ids truncated to fit `max_len`."""
        ids = [self.vocab[t] for t in self.tokenize(text)][:max_len - 2]
        return [self.vocab["[CLS]"]] + ids + [self.vocab["[SEP]"]]

    def encode_batch(self, texts: Sequence[str], max_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (input_ids, attention_mask), each (len(texts), max_len)
        int64."""
        ids = torch.full((len(texts), max_len), self.vocab["[PAD]"],
                         dtype=torch.long)
        mask = torch.zeros((len(texts), max_len), dtype=torch.long)
        for i, text in enumerate(texts):
            row = self.encode(text, max_len)
            ids[i, :len(row)] = torch.tensor(row)
            mask[i, :len(row)] = 1
        return ids, mask
