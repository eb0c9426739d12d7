"""Learning-rate schedules and the optimizer (JAX package `ops/schedule.py`),
with optax's semantics: the schedule is read at the optimizer's count
before the update (the first update uses step 0), and Adam puts eps
outside the square root, as `torch.optim.Adam` does.

- "constant": Adam(lr) with optax's defaults (0.9, 0.999, 1e-8);
- "noam": the reference's CustomSchedule, d_model^-0.5 *
  min(s^-0.5, s * warmup^-1.5) with s = max(step, 1), and Adam
  (0.9, 0.98, 1e-9);
- "cosine": optax's `warmup_cosine_decay_schedule` (linear warmup from
  lr/10 to lr over min(warmup, decay/10) steps, then cosine decay to lr/20
  at decay_steps), with Adam's defaults.

Schedules compute in f32, as optax's do under jit.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]


def noam_schedule(d_model: int, warmup_steps: int = 4000) -> Schedule:
    def schedule(step: int) -> float:
        s = np.maximum(np.float32(step), np.float32(1.0))
        return float(np.float32(d_model) ** np.float32(-0.5) * np.minimum(
            s ** np.float32(-0.5),
            s * np.float32(warmup_steps) ** np.float32(-1.5)))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule, written out: a linear schedule
    init -> peak over warmup_steps, joined at warmup_steps to a cosine
    decay from peak over decay_steps - warmup_steps with
    alpha = end/peak."""
    f = np.float32
    alpha = f(0.0) if peak_value == 0.0 else f(end_value) / f(peak_value)
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, "
                         f"got {decay_steps} and {warmup_steps}")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = f(1.0) - f(step) / f(warmup_steps)
            return float((f(init_value) - f(peak_value)) * frac
                         + f(peak_value))
        count = f(min(step - warmup_steps, span))
        cosine = f(0.5) * (f(1.0) + np.cos(f(np.pi) * count / f(span)))
        return float(f(peak_value) * ((f(1.0) - alpha) * cosine + alpha))

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 5e-4,
                   schedule: str = "constant", d_model: int = 128,
                   warmup_steps: int = 4000, decay_steps: int = 40000
                   ) -> Tuple[torch.optim.Adam, Schedule]:
    """-> (Adam over `params`, the schedule step -> lr)."""
    betas, eps = (0.9, 0.999), 1e-8
    if schedule == "noam":
        lr_fn = noam_schedule(d_model, warmup_steps)
        betas, eps = (0.9, 0.98), 1e-9
    elif schedule == "cosine":
        lr_fn = warmup_cosine_decay_schedule(
            lr / 10, lr, min(warmup_steps, decay_steps // 10), decay_steps,
            lr / 20)
    elif schedule == "constant":
        def lr_fn(step: int) -> float:
            return lr
    else:
        raise ValueError(f"schedule {schedule!r}: constant, noam or cosine")
    return torch.optim.Adam(params, lr=lr_fn(0), betas=betas, eps=eps), lr_fn
