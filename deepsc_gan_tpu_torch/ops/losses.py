"""Masked cross-entropy from materialized logits (JAX package
`ops/losses.py`): sparse softmax CE in f32, zeroed where the target is
<PAD>, then the mean over ALL (B, L) positions (padded positions count in
the denominator), as the reference's published curves were trained.

Quirk Q2: the reference means to mask ids 4 and 5 too, but a bug leaves it
pad-only; `extra_masked_ids` gives the intended behaviour.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def cross_entropy_per_token(real: torch.Tensor,
                            logits: torch.Tensor) -> torch.Tensor:
    """real (B, L) int; logits (B, L, V) -> (B, L) f32 CE."""
    logits = logits.float()
    gold = logits.gather(-1, real.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def loss_mask(real: torch.Tensor, pad_idx: int = 0,
              extra_masked_ids: Optional[Sequence[int]] = None
              ) -> torch.Tensor:
    """(B, L) f32: 1 where the target counts, 0 at <PAD> (and the extra
    ids)."""
    mask = (real != pad_idx).float()
    for tid in extra_masked_ids or ():
        mask = mask * (real != tid).float()
    return mask


def loss_function(real: torch.Tensor, logits: torch.Tensor, pad_idx: int = 0,
                  extra_masked_ids: Optional[Sequence[int]] = None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Reference-parity masked CE; `label_smoothing` alpha gives
    logZ - (1 - alpha) logit_gold - alpha mean_v(logit_v)."""
    ce = cross_entropy_per_token(real, logits)
    if label_smoothing:
        lg32 = logits.float()
        gold = lg32.gather(-1, real.long()[..., None])[..., 0]
        ce = ce + label_smoothing * (gold - lg32.mean(dim=-1))
    return torch.mean(ce * loss_mask(real, pad_idx, extra_masked_ids))
