"""The native (C++) text passes, bound with `ctypes` (JAX package
`native/`): `text_pipeline.cc` fuses the corpus normalization's five regex
passes into one C pass a line, `bleu.cc` scores sentence BLEU with NLTK's
semantics over integer token ids, and a post-padding of id lists.

The sources are the port's own copies. `g++` compiles them into
`_build/native-<hash>/libtextpipe.so`, where the hash covers the sources
and the command, as `ops/build.py` builds the CUDA kernels: an edited source
is rebuilt, an unchanged one loaded from the earlier build. Nothing is
compiled when the module is imported. `load()` builds on first use and
returns None when no compiler is found or the build fails (the callers then
take their Python paths, which are the reference these functions are tested
against); `build()` raises instead, for a caller that must have the
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCES = ("text_pipeline.cc", "bleu.cc")
HEADERS = ("fold_table.inc",)
_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def target() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((_DIR / name).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}" / "libtextpipe.so"


def build() -> Path:
    """Compile the library unless it is built from these sources already;
    -> its path. Raises with the compiler's output when it fails, or when
    no `g++` is found."""
    out = target()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, *(str(_DIR / s) for s in SOURCES),
           "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees old or new
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ip = ctypes.POINTER(ctypes.c_int)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.dsc_normalize.restype = ctypes.c_int
    lib.dsc_normalize.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.dsc_normalize_batch.restype = ctypes.c_int
    lib.dsc_normalize_batch.argtypes = [
        ctypes.c_char_p, ip, ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ip]
    lib.dsc_pad_sequences.restype = None
    lib.dsc_pad_sequences.argtypes = [
        ip, ip, ctypes.c_int, ctypes.c_int, ctypes.c_int, ip]
    lib.dsc_bleu_batch.restype = ctypes.c_int
    lib.dsc_bleu_batch.argtypes = [ip, ip, ip, ip, ctypes.c_int, dp, dp]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None when it cannot be built (the
    reason is kept for the functions below to raise with)."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        return None
    try:
        path = build()
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        _build_error = str(e)
        return None
    _lib = _bind(ctypes.CDLL(str(path)))
    return _lib


def available() -> bool:
    return load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native build failed: {_build_error}")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _offsets(lengths: Sequence[int]) -> np.ndarray:
    off = np.zeros(len(lengths) + 1, np.int32)
    np.cumsum(lengths, out=off[1:])
    return off


def normalize_string(s: str) -> str:
    """Native `data.preprocess.normalize_string`."""
    lib = _lib_or_raise()
    raw = s.encode("utf-8")
    cap = 2 * len(raw) + 16
    out = ctypes.create_string_buffer(cap)
    n = lib.dsc_normalize(raw, len(raw), out, cap)
    if n < 0:
        raise RuntimeError("normalize buffer overflow")
    return out.raw[:n].decode("ascii")


def normalize_lines(lines: Sequence[str]) -> List[str]:
    """`normalize_string` of every line, in one C call."""
    lib = _lib_or_raise()
    blobs = [s.encode("utf-8") for s in lines]
    buf = b"".join(blobs)
    offsets = _offsets([len(b) for b in blobs])
    out_cap = 2 * len(buf) + 16 * len(blobs) + 16
    out = ctypes.create_string_buffer(out_cap)
    out_offsets = np.zeros(len(blobs) + 1, np.int32)
    n = lib.dsc_normalize_batch(buf, _ptr(offsets), len(blobs), out,
                                out_cap, _ptr(out_offsets))
    if n < 0:
        raise RuntimeError("normalize buffer overflow")
    raw = out.raw
    return [raw[out_offsets[i]:out_offsets[i + 1]].decode("ascii")
            for i in range(len(blobs))]


def _flatten(seqs: Sequence[Sequence[int]]):
    flat = np.fromiter((t for s in seqs for t in s), np.int32,
                       count=sum(len(s) for s in seqs))
    return flat, _offsets([len(s) for s in seqs])


def bleu_batch(refs: Sequence[Sequence[int]], hyps: Sequence[Sequence[int]],
               weights: Sequence[float]) -> np.ndarray:
    """Sentence BLEU of each (reference, hypothesis) pair of integer token
    sequences, NLTK `sentence_bleu`'s semantics (one reference, method0
    smoothing); -> (N,) f64. Words are interned to ids by the caller
    (`evaluate.metrics.BleuScore`)."""
    lib = _lib_or_raise()
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references, {len(hyps)} hypotheses")
    rflat, roff = _flatten(refs)
    hflat, hoff = _flatten(hyps)
    w = np.asarray(list(weights) + [0.0] * (4 - len(weights)), np.float64)
    out = np.empty(len(refs), np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.dsc_bleu_batch(_ptr(rflat), _ptr(roff), _ptr(hflat), _ptr(hoff),
                       len(refs), w.ctypes.data_as(dp),
                       out.ctypes.data_as(dp))
    return out


def pad_sequences(seqs: Sequence[Sequence[int]], maxlen: int = 31,
                  pad_value: int = 0) -> np.ndarray:
    """Native `data.loader.pad_sequences`: post-pad and post-truncate to
    (N, maxlen) int32."""
    lib = _lib_or_raise()
    flat, offsets = _flatten(seqs)
    out = np.empty((len(seqs), maxlen), np.int32)
    lib.dsc_pad_sequences(_ptr(flat), _ptr(offsets), len(seqs), maxlen,
                          pad_value, _ptr(out))
    return out
