"""SNR-sweep evaluation producing reference-format tables (JAX package
`evaluate/evaluator.py`): the decoded sweeps `snr_sweep_bleu` and
`snr_sweep_bleu_fast`, and the teacher-forced attack table
`teacher_forced_sweep`, each scoring with `make_scorers(metric)`: BLEU, the
sentence similarity, or both, one column each in that order. A scorer is
called once per (SNR, batch), the JAX package's grouping, which the BERT
similarity's per-batch normalisation depends on."""

from __future__ import annotations

import os
import pickle
import sys
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from deepsc_gan_tpu_torch.data.vocab import SeqToText, Vocab
from deepsc_gan_tpu_torch.evaluate.metrics import (
    BleuScore,
    Similarity,
    SNR_to_noise,
    UnigramSimilarity,
)
from deepsc_gan_tpu_torch.models.channel import draw_channel
from deepsc_gan_tpu_torch.utils.config import Config

METRICS = ("bleu", "similarity", "both")


def make_scorers(metric: str = "bleu", bleu_weights=(1.0, 0.0, 0.0, 0.0),
                 bert_path: Optional[str] = None, device=None) -> list:
    """[(name, scorer)] for `metric` in {bleu, similarity, both}. The
    similarity is BERT's from the local weights at `bert_path` (default
    the DEEPSC_BERT_PATH environment variable, else `bert-base-uncased`: a
    local directory or a snapshot in the local Hugging Face cache, never
    fetched), its BERT on `device`; where no weights are found, a warning
    on stderr and `UnigramSimilarity`, as the JAX package does."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; one of {METRICS}")
    if bert_path is None:
        bert_path = os.environ.get("DEEPSC_BERT_PATH", "bert-base-uncased")
    scorers = []
    if metric in ("bleu", "both"):
        scorers.append(("bleu", BleuScore(*bleu_weights)))
    if metric in ("similarity", "both"):
        try:
            scorers.append(("similarity", Similarity(bert_path,
                                                     device=device)))
        except FileNotFoundError as e:
            print(f"[metrics] BERT similarity unavailable ({e}); using "
                  "unigram-cosine fallback", file=sys.stderr)
            scorers.append(("similarity", UnigramSimilarity()))
    return scorers


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
    metric: str = "bleu",
) -> List[List[float]]:
    """-> [[snr, mean metric...], ...] (a column per `make_scorers(metric)`
    scorer): one `decode_fn(inp, pnr_db, n_std,
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
    scorers = make_scorers(metric, bleu_weights, device=device)
    table = []
    for snr in snrs:
        n_std = SNR_to_noise(snr)
        scores = [[] for _ in scorers]
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
            for si, (_, sc) in enumerate(scorers):
                scores[si].extend(sc.compute_score(ref, hyp))
        table.append([float(snr)] + [float(np.mean(x)) for x in scores])
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
    metric: str = "bleu",
) -> List[List[float]]:
    """-> [[snr, mean metric...], ...]: every SNR point of a batch decoded in
    one `sweep_fn(inp, pnr_db, n_stds, noise, fade)` call (evaluate.greedy.
    make_greedy_decode_sweep), the channel noise and the fade of a fading
    channel (one per SNR point) drawn from `generator` (`draw_channel`).
    Hypotheses and references skip the leading <START>."""
    device = generator.device
    s2t = SeqToText(vocab, cfg.end_idx)
    scorers = make_scorers(metric, bleu_weights, device=device)
    n_stds = torch.tensor([SNR_to_noise(s) for s in snrs],
                          dtype=torch.float32, device=device)
    scores = [[[] for _ in scorers] for _ in snrs]
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
            for mi, (_, sc) in enumerate(scorers):
                scores[si][mi].extend(sc.compute_score(ref, hyp))
    return [[float(s)] + [float(np.mean(m)) for m in sc]
            for s, sc in zip(snrs, scores)]


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
    metric: str = "bleu",
) -> List[List[float]]:
    """The teacher-forced attack table in the reference's `eval.pkl` layout,
    one row per SNR:

        [snr, clean metric..., attacked metric..., loss_clean,
         loss_attacked]

    `step_fn(inp, tar, generator, pnr_db, n_std, epsilon)` is one of
    train.steps.make_eval_step / make_eval_step_pgd: -> (clean_loss,
    attacked_loss, clean_logits, attacked_logits, ...), drawing its channels
    from `generator`. The clean and attacked predictions (argmax on the
    device) are scored against the input without its <START>; a star
    decoder's predictions (one per input position) drop their first slot.
    Losses and scores are means over the batches."""
    device = generator.device
    s2t = SeqToText(vocab, cfg.end_idx)
    scorers = make_scorers(metric, bleu_weights, device=device)
    table = []
    for snr in snrs:
        n_std = SNR_to_noise(snr)
        cls, als = [], []
        cscores = [[] for _ in scorers]
        ascores = [[] for _ in scorers]
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
                for mi, (_, sc) in enumerate(scorers):
                    dest[mi].extend(sc.compute_score(ref, hyp))
        table.append([float(snr)] + [float(np.mean(x)) for x in cscores]
                     + [float(np.mean(x)) for x in ascores]
                     + [float(np.mean(cls)), float(np.mean(als))])
    return table


def save_result_table(table: List[List[float]], path: str) -> None:
    """Pickle a results table in the reference layout (a list of
    [snr, metric...] rows)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(table, f)
