"""Europarl corpus preprocessing (JAX package `data/preprocess.py:36-163`,
its native pass or its Python path): NFD unicode fold, tag strip, `!.?`
spaced out, everything but `[a-zA-Z.!?]` turned to spaces, lower case; sentences of 5 to 29 words;
order-preserving dedupe; `;` and `,` kept as tokens and `?` and `.` removed
at tokenize time; a sorted vocab after the specials; <START>/<END> around
each sentence; a 90/10 train/test split by `round`. Outputs: the vocab JSON
`{"token_to_idx": ...}` and pickles of id lists.

    python -m deepsc_gan_tpu_torch.data.preprocess --input-data-dir DIR \
        --output-train-dir train.pkl --output-test-dir test.pkl \
        --output-vocab vocab.json
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
import unicodedata
from typing import Iterable, List, Sequence, Tuple

from deepsc_gan_tpu_torch import native as native_text
from deepsc_gan_tpu_torch.data.vocab import Vocab

_TAG_RE = re.compile(r"<[^>]*>")
_PUNCT_SPACE_RE = re.compile(r"([!.?])")
_NON_ALPHA_RE = re.compile(r"[^a-zA-Z.!?]+")
_WS_RE = re.compile(r"\s+")

PUNCT_TO_KEEP = [";", ","]
PUNCT_TO_REMOVE = ["?", "."]


def unicode_to_ascii(s: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", s)
                   if unicodedata.category(c) != "Mn")


def remove_tags(s: str) -> str:
    return _TAG_RE.sub("", s)


def normalize_string(s: str) -> str:
    s = unicode_to_ascii(s)
    s = remove_tags(s)
    s = _PUNCT_SPACE_RE.sub(r" \1", s)
    s = _NON_ALPHA_RE.sub(r" ", s)
    s = _WS_RE.sub(r" ", s)
    return s.lower()


def cutted_data(cleaned: Iterable[str], min_length: int = 4,
                max_length: int = 30) -> List[str]:
    """The lines of strictly more than `min_length` and fewer than
    `max_length` words, their whitespace collapsed."""
    out = []
    for line in cleaned:
        n = len(line.split())
        if min_length < n < max_length:
            out.append(" ".join(line.split()))
    return out


def process_file(text_path: str, native: bool = True) -> List[str]:
    """The file's lines normalized and cut: by the native pass
    (`native.normalize_lines`, one C call for the file) when `native` and
    the library builds, else by `normalize_string`."""
    with open(text_path, "r", encoding="utf8") as f:
        raw = f.read()
    lines = raw.strip().split("\n")
    if native and native_text.available():
        return cutted_data(native_text.normalize_lines(lines))
    return cutted_data(normalize_string(s) for s in lines)


def tokenize(s: str, delim: str = " ", add_start_token: bool = True,
             add_end_token: bool = True,
             punct_to_keep: Sequence[str] = None,
             punct_to_remove: Sequence[str] = None) -> List[str]:
    if punct_to_keep is not None:
        for p in punct_to_keep:
            s = s.replace(p, f"{delim}{p}")
    if punct_to_remove is not None:
        for p in punct_to_remove:
            s = s.replace(p, "")
    tokens = s.split(delim)
    if add_start_token:
        tokens.insert(0, "<START>")
    if add_end_token:
        tokens.append("<END>")
    return tokens


def dedupe(sentences: Iterable[str]) -> List[str]:
    return list(dict.fromkeys(sentences))


def preprocess_corpus(input_dir: str
                      ) -> Tuple[Vocab, List[List[int]], List[List[int]]]:
    """Every `*.txt` of `input_dir`, in name order -> (vocab, train id
    lists, test id lists)."""
    sentences: List[str] = []
    for fn in sorted(os.listdir(input_dir)):
        if fn.endswith(".txt"):
            sentences += process_file(os.path.join(input_dir, fn))
    sentences = dedupe(sentences)
    vocab = Vocab.build(
        tokenize(s, add_start_token=False, add_end_token=False,
                 punct_to_keep=PUNCT_TO_KEEP, punct_to_remove=PUNCT_TO_REMOVE)
        for s in sentences)
    results = [[vocab.token_to_idx[w]
                for w in tokenize(s, punct_to_keep=PUNCT_TO_KEEP,
                                  punct_to_remove=PUNCT_TO_REMOVE)]
               for s in sentences]
    split = round(len(results) * 0.9)
    return vocab, results[:split], results[split:]


def add_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--input-data-dir", default="data/txt/en")
    parser.add_argument("--output-train-dir",
                        default="data/txt/train_data.pkl")
    parser.add_argument("--output-test-dir", default="data/txt/test_data.pkl")
    parser.add_argument("--output-vocab", default="data/txt/vocab.json")


def run(args: argparse.Namespace) -> dict:
    """Preprocess and write the three files; -> {"vocab", "train",
    "test"}."""
    vocab, train_data, test_data = preprocess_corpus(args.input_data_dir)
    print(f"Number of sentences: {len(train_data) + len(test_data)}")
    print(f"Number of words in Vocab: {len(vocab)}")
    if args.output_vocab:
        os.makedirs(os.path.dirname(args.output_vocab) or ".", exist_ok=True)
        vocab.save(args.output_vocab)
    with open(args.output_train_dir, "wb") as f:
        pickle.dump(train_data, f)
    with open(args.output_test_dir, "wb") as f:
        pickle.dump(test_data, f)
    print(f"Saved: {args.output_vocab}, {args.output_train_dir}, "
          f"{args.output_test_dir}")
    return {"vocab": vocab, "train": train_data, "test": test_data}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_args(parser)
    return run(parser.parse_args(argv))


if __name__ == "__main__":
    main()
