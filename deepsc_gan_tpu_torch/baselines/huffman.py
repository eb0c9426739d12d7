"""Word-level Huffman source coding (JAX package `baselines/huffman.py`):
the Huffman code of the corpus's word frequencies, words to and from numpy
bit arrays. Decoding walks the prefix tree bit by bit; after channel errors
the walk loses its place, the classical cliff effect, kept on purpose."""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Iterable, Sequence

import numpy as np


class HuffmanCodec:
    """Huffman code built from corpus word frequencies (ties broken by the
    sorted word order, then by the order merged nodes were made)."""

    def __init__(self, sentences: Iterable[Sequence[str]]):
        freqs = Counter()
        for words in sentences:
            freqs.update(words)
        if len(freqs) < 2:
            raise ValueError("need at least two distinct words")
        # heap of (freq, tiebreak, node); node = word | (left, right)
        heap = [(f, i, w) for i, (w, f) in enumerate(sorted(freqs.items()))]
        heapq.heapify(heap)
        n = len(heap)
        while len(heap) > 1:
            f1, _, a = heapq.heappop(heap)
            f2, _, b = heapq.heappop(heap)
            n += 1
            heapq.heappush(heap, (f1 + f2, n, (a, b)))
        self._root = heap[0][2]
        self._code: dict[str, tuple[int, ...]] = {}
        stack = [(self._root, ())]
        while stack:
            node, prefix = stack.pop()
            if isinstance(node, tuple):
                stack.append((node[0], prefix + (0,)))
                stack.append((node[1], prefix + (1,)))
            else:
                self._code[node] = prefix

    @property
    def code(self) -> dict[str, tuple[int, ...]]:
        return self._code

    def word_lengths(self, words: Sequence[str]) -> np.ndarray:
        """Per-word codeword lengths, int32."""
        return np.array([len(self._code[w]) for w in words], dtype=np.int32)

    def encode(self, words: Sequence[str]) -> np.ndarray:
        """-> uint8 bit array."""
        bits: list[int] = []
        for w in words:
            bits.extend(self._code[w])
        return np.array(bits, dtype=np.uint8)

    def decode(self, bits: np.ndarray, max_words: int | None = None
               ) -> list[str]:
        """Prefix-tree walk; a trailing partial codeword is dropped."""
        out: list[str] = []
        node = self._root
        for b in np.asarray(bits, dtype=np.uint8):
            node = node[int(b)]
            if not isinstance(node, tuple):
                out.append(node)
                node = self._root
                if max_words is not None and len(out) >= max_words:
                    break
        return out
