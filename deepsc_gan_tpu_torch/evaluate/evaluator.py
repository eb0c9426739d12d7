"""SNR-sweep evaluation producing reference-format BLEU tables (JAX
package `evaluate/evaluator.py:57-200`): the decoded sweeps
`snr_sweep_bleu` and `snr_sweep_bleu_fast`, and the teacher-forced attack
table `teacher_forced_sweep`."""

from __future__ import annotations

import os
import pickle
from typing import Callable, List, Sequence

import numpy as np
import torch

from deepsc_gan_tpu_torch.data.vocab import SeqToText, Vocab
from deepsc_gan_tpu_torch.evaluate.metrics import BleuScore, SNR_to_noise
from deepsc_gan_tpu_torch.models.channel import draw_channel
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
    draws: int = 1,
    decode_extra_args: tuple = (),
) -> List[List[float]]:
    """-> [[snr, mean BLEU], ...]: one `decode_fn(inp, pnr_db, n_std,
    noise, fade, *decode_extra_args)` call per (SNR, batch), which returns
    the ids or a tuple led by them
    (evaluate.beam.make_beam_decode_kv, say), SNR-major, the channel noise
    (B, L, channel_dim) and the fade of a fading channel drawn from
    `generator` before each call (`draw_channel`; with `draws` > 1 that many
    stacked on a leading axis, as the attacked decode takes them).
    Hypotheses and references skip the leading <START>."""
    device = generator.device
    lead = (draws,) if draws > 1 else ()
    s2t = SeqToText(vocab, cfg.end_idx)
    scorer = BleuScore(*bleu_weights)
    table = []
    for snr in snrs:
        n_std = SNR_to_noise(snr)
        scores = []
        for inp in batches:
            inp_t = torch.as_tensor(np.asarray(inp), dtype=torch.long,
                                    device=device)
            noise, fade = draw_channel(
                generator, (inp_t.shape[0], inp_t.shape[1], cfg.channel_dim),
                cfg.channel, cfg.fading_per_sample, lead)
            out = decode_fn(inp_t, pnr_db, n_std, noise, fade,
                            *decode_extra_args)
            # greedy_gan's (ids, noa): the ids are scored
            ids = (out[0] if isinstance(out, tuple) else out).cpu().numpy()
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
    one `sweep_fn(inp, pnr_db, n_stds, noise, fade)` call (evaluate.greedy.
    make_greedy_decode_sweep), the channel noise and the fade of a fading
    channel (one per SNR point) drawn from `generator` (`draw_channel`).
    Hypotheses and references skip the leading <START>."""
    device = generator.device
    s2t = SeqToText(vocab, cfg.end_idx)
    scorer = BleuScore(*bleu_weights)
    n_stds = torch.tensor([SNR_to_noise(s) for s in snrs],
                          dtype=torch.float32, device=device)
    scores = [[] for _ in snrs]
    for inp in batches:
        inp_t = torch.as_tensor(np.asarray(inp), dtype=torch.long,
                                device=device)
        noise, fade = draw_channel(
            generator, (inp_t.shape[0], inp_t.shape[1], cfg.channel_dim),
            cfg.channel, cfg.fading_per_sample, (len(snrs),))
        ids = sweep_fn(inp_t, pnr_db, n_stds, noise, fade).cpu().numpy()
        ref = [s2t.sequence_to_text(row[1:]) for row in np.asarray(inp)]
        for si in range(len(snrs)):
            hyp = [s2t.sequence_to_text(row[1:]) for row in ids[si]]
            scores[si].extend(scorer.compute_score(ref, hyp))
    return [[float(s), float(np.mean(sc))] for s, sc in zip(snrs, scores)]


def teacher_forced_sweep(
    step_fn: Callable,
    batches: Sequence[np.ndarray],
    vocab: Vocab,
    cfg: Config,
    generator: torch.Generator,
    snrs: Sequence[float] = tuple(range(0, 19)),
    pnr_db: float = 0.0,
    epsilon: float = 1.0,
    bleu_weights=(1.0, 0.0, 0.0, 0.0),
) -> List[List[float]]:
    """The teacher-forced attack table in the reference's `eval.pkl` layout,
    one row per SNR:

        [snr, clean BLEU, attacked BLEU, loss_clean, loss_attacked]

    `step_fn(inp, tar, generator, pnr_db, n_std, epsilon)` is one of
    train.steps.make_eval_step / make_eval_step_pgd: -> (clean_loss,
    attacked_loss, clean_logits, attacked_logits, ...), drawing its channels
    from `generator`. The clean and attacked predictions (argmax on the
    device) are scored against the input without its <START>; a star
    decoder's predictions (one per input position) drop their first slot.
    Losses and scores are means over the batches."""
    device = generator.device
    s2t = SeqToText(vocab, cfg.end_idx)
    scorer = BleuScore(*bleu_weights)
    table = []
    for snr in snrs:
        n_std = SNR_to_noise(snr)
        cls, als, cscores, ascores = [], [], [], []
        for inp in batches:
            inp_t = torch.as_tensor(np.asarray(inp), dtype=torch.long,
                                    device=device)
            out = step_fn(inp_t, inp_t, generator, pnr_db, n_std, epsilon)
            cls.append(float(out[0]))
            als.append(float(out[1]))
            ref = [s2t.sequence_to_text(row[1:]) for row in np.asarray(inp)]
            for logits, dest in ((out[2], cscores), (out[3], ascores)):
                ids = torch.argmax(logits, dim=-1).cpu().numpy()
                if ids.shape[1] == inp_t.shape[1]:
                    ids = ids[:, 1:]
                hyp = [s2t.sequence_to_text(row) for row in ids]
                dest.extend(scorer.compute_score(ref, hyp))
        table.append([float(snr), float(np.mean(cscores)),
                      float(np.mean(ascores)), float(np.mean(cls)),
                      float(np.mean(als))])
    return table


def save_result_table(table: List[List[float]], path: str) -> None:
    """Pickle a results table in the reference layout (a list of
    [snr, metric] rows)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(table, f)
