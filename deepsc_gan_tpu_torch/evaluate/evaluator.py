"""SNR-sweep evaluation producing reference-format BLEU tables (JAX
package `evaluate/evaluator.py:57-128`, `snr_sweep_bleu` and
`snr_sweep_bleu_fast`)."""

from __future__ import annotations

import os
import pickle
from typing import Callable, List, Sequence

import numpy as np
import torch

from deepsc_gan_tpu_torch.data.vocab import SeqToText, Vocab
from deepsc_gan_tpu_torch.evaluate.metrics import BleuScore, SNR_to_noise
from deepsc_gan_tpu_torch.utils.config import Config


def snr_sweep_bleu(
    decode_fn: Callable,
    batches: Sequence[np.ndarray],
    vocab: Vocab,
    cfg: Config,
    generator: torch.Generator,
    snrs: Sequence[float] = tuple(range(0, 19)),
    pnr_db: float = 0.0,
    bleu_weights=(1.0, 0.0, 0.0, 0.0),
) -> List[List[float]]:
    """-> [[snr, mean BLEU], ...]: one `decode_fn(inp, pnr_db, n_std,
    noise)` call per (SNR, batch) (evaluate.beam.make_beam_decode_kv, say),
    SNR-major, the channel noise (B, L, channel_dim) drawn from `generator`
    on its device before each call. Hypotheses and references skip the
    leading <START>."""
    device = generator.device
    s2t = SeqToText(vocab, cfg.end_idx)
    scorer = BleuScore(*bleu_weights)
    table = []
    for snr in snrs:
        n_std = SNR_to_noise(snr)
        scores = []
        for inp in batches:
            inp_t = torch.as_tensor(np.asarray(inp), dtype=torch.long,
                                    device=device)
            noise = torch.randn(
                (inp_t.shape[0], inp_t.shape[1], cfg.channel_dim),
                generator=generator, device=device, dtype=torch.float32)
            ids = decode_fn(inp_t, pnr_db, n_std, noise).cpu().numpy()
            hyp = [s2t.sequence_to_text(row[1:]) for row in ids]
            ref = [s2t.sequence_to_text(row[1:]) for row in np.asarray(inp)]
            scores.extend(scorer.compute_score(ref, hyp))
        table.append([float(snr), float(np.mean(scores))])
    return table


def snr_sweep_bleu_fast(
    sweep_fn: Callable,
    batches: Sequence[np.ndarray],
    vocab: Vocab,
    cfg: Config,
    generator: torch.Generator,
    snrs: Sequence[float] = tuple(range(0, 19)),
    pnr_db: float = 0.0,
    bleu_weights=(1.0, 0.0, 0.0, 0.0),
) -> List[List[float]]:
    """-> [[snr, mean BLEU], ...]: every SNR point of a batch decoded in
    one `sweep_fn(inp, pnr_db, n_stds, noise)` call (evaluate.greedy.
    make_greedy_decode_sweep), the channel noise drawn from `generator` on
    its device. Hypotheses and references skip the leading <START>."""
    device = generator.device
    s2t = SeqToText(vocab, cfg.end_idx)
    scorer = BleuScore(*bleu_weights)
    n_stds = torch.tensor([SNR_to_noise(s) for s in snrs],
                          dtype=torch.float32, device=device)
    scores = [[] for _ in snrs]
    for inp in batches:
        inp_t = torch.as_tensor(np.asarray(inp), dtype=torch.long,
                                device=device)
        noise = torch.randn(
            (len(snrs), inp_t.shape[0], inp_t.shape[1], cfg.channel_dim),
            generator=generator, device=device, dtype=torch.float32)
        ids = sweep_fn(inp_t, pnr_db, n_stds, noise).cpu().numpy()
        ref = [s2t.sequence_to_text(row[1:]) for row in np.asarray(inp)]
        for si in range(len(snrs)):
            hyp = [s2t.sequence_to_text(row[1:]) for row in ids[si]]
            scores[si].extend(scorer.compute_score(ref, hyp))
    return [[float(s), float(np.mean(sc))] for s, sc in zip(snrs, scores)]


def save_result_table(table: List[List[float]], path: str) -> None:
    """Pickle a results table in the reference layout (a list of
    [snr, metric] rows)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(table, f)
