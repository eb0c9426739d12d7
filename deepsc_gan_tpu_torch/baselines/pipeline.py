"""The classical Huffman + turbo + QAM BLEU-vs-SNR sweep (JAX package
`baselines/pipeline.py`): word-level Huffman, one rate-1/3 turbo block per
sentence, Gray M-QAM, AWGN (and, for the attacked column, a perturbation
at `pnr_db` against each symbol), max-log LLR demapping, the iterative
BCJR on the device, Huffman decoding, BLEU-1. Rows
[snr, bleu_attacked, bleu_clean] (the reference's `Turbo+FGM.pkl` layout).
The channel noise is numpy's `default_rng(seed)`, drawn as the JAX package
draws it, so a row can equal the JAX package's exactly."""

from __future__ import annotations

import time
from typing import Sequence, Union

import numpy as np
import torch

from deepsc_gan_tpu_torch.baselines.huffman import HuffmanCodec
from deepsc_gan_tpu_torch.baselines.modem import QamModem
from deepsc_gan_tpu_torch.baselines.turbo import TurboCodec
from deepsc_gan_tpu_torch.evaluate.metrics import BleuScore


def classical_sweep(
    sentences: Sequence[str],
    snrs: Sequence[float],
    block_k: int = 512,
    iters: int = 6,
    mod_bits: int = 6,
    pnr_db: float = 10.0,
    seed: int = 0,
    verbose: bool = True,
    include_attacked: bool = True,
    coding: str = "turbo",
    device: Union[str, torch.device, None] = None,
    seconds: list = None,
) -> list[list[float]]:
    """-> rows [snr, bleu_attacked, bleu_clean] over `snrs`
    (`include_attacked=False`: [snr, nan, bleu_clean], half the decoding).
    `coding="none"` sends the Huffman bits uncoded (hard decisions, no
    turbo). The BCJR runs on `device` (CUDA unless another is named).
    `seconds`, when given, gets each SNR point's wall seconds."""
    if coding not in ("turbo", "none"):
        raise ValueError(f"coding must be 'turbo' or 'none', got {coding}")
    words = [s.split() for s in sentences]
    huff = HuffmanCodec(words)
    enc = [huff.encode(w) for w in words]
    n_bits = np.array([len(b) for b in enc])
    if n_bits.max() > block_k:
        raise ValueError(
            f"longest sentence needs {n_bits.max()} bits > block_k")
    if verbose:
        print(f"{len(sentences)} sentences, Huffman bits/sentence "
              f"mean={n_bits.mean():.1f} max={n_bits.max()}", flush=True)

    # one turbo block per sentence
    flat = np.zeros((len(enc), block_k), dtype=np.uint8)
    for i, b in enumerate(enc):
        flat[i, : len(b)] = b
    modem = QamModem(mod_bits)
    if coding == "none":
        tc = None
        n_total = flat.size
        tx = modem.modulate(flat.ravel())
    else:
        tc = TurboCodec(block_k=block_k, iters=iters, seed=seed,
                        device=device)
        sym, n_total = tc.encode(flat.ravel())
        coded_bits = (sym < 0).astype(np.uint8)  # (3, n_sent, K)
        tx = modem.modulate(coded_bits)
    if verbose:
        print(f"coding={coding}: {n_total} bits -> {len(tx)} QAM symbols",
              flush=True)

    bleu = BleuScore(1, 0, 0, 0)
    rng = np.random.default_rng(seed)
    rows = []
    for snr in snrs:
        t0 = time.perf_counter()
        snr = float(snr)
        sigma = float(1.0 / np.sqrt(10.0 ** (snr / 10.0)))
        noise = sigma / np.sqrt(2.0) * (
            rng.standard_normal(len(tx))
            + 1j * rng.standard_normal(len(tx)))
        scores = {True: float("nan")}
        for attacked in ((True, False) if include_attacked else (False,)):
            y = tx + noise
            if attacked:
                # push each symbol against itself at PNR dB over the noise
                # power: the FGM direction for a distance demapper
                amp = sigma * np.sqrt(10.0 ** (pnr_db / 10.0))
                safe = np.where(np.abs(tx) > 0, np.abs(tx), 1.0)
                y = y - amp * tx / safe
            llr_flat = modem.llr(y, sigma)
            if coding == "none":
                dec = (llr_flat[: flat.size] < 0).astype(
                    np.uint8).reshape(len(enc), block_k)
            else:
                llr = llr_flat[: coded_bits.size].reshape(coded_bits.shape)
                dec = tc.decode(llr, n_total).reshape(len(enc), block_k)
            hyps = [" ".join(huff.decode(dec[i, : n_bits[i]]))
                    for i in range(len(enc))]
            scores[attacked] = float(np.mean(
                bleu.compute_score(list(sentences), hyps)))
        rows.append([snr, scores[True], scores[False]])
        if seconds is not None:
            seconds.append(time.perf_counter() - t0)
        if verbose:
            print(f"SNR={snr:4.1f}dB attacked={scores[True]:.4f} "
                  f"clean={scores[False]:.4f}", flush=True)
    return rows
