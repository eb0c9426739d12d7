"""Masked cross-entropy from decoder hidden states and the vocab table
(JAX package `ops/fused_ce.py:fused_ce_loss`): the per-row CE through the
online-softmax kernels (`ops/ce_kernel.py`; the (B*L, V) logits are never
materialized), label smoothing outside the kernels' VJP, then the pad mask,
the optional `extra_masked_ids` (quirk Q2) and the mean over all B x L
positions, as `ops/losses.py:loss_function` normalizes (the global
batch's under a data-parallel shard).

The JAX package picks its CE path by size on the TPU (a lax.scan below
4,096 rows); the port takes the kernels at every size.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from deepsc_gan_tpu_torch.ops.ce_kernel import softmax_xent
from deepsc_gan_tpu_torch.ops.losses import loss_mask
from deepsc_gan_tpu_torch.parallel.batch import global_mean


def fused_ce_loss(hidden: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                  real: torch.Tensor, pad_idx: int = 0,
                  extra_masked_ids: Optional[Sequence[int]] = None,
                  label_smoothing: float = 0.0,
                  plain: bool = False) -> torch.Tensor:
    """hidden (B, L, D); W (V, D); b (V,); real (B, L) -> scalar f32 loss.

    Label smoothing adds `alpha * (logit_gold - mean_v logit_v)` per row:
    both terms are O(N D) (a label gather and a product with the vocab-mean
    row of W), so plain autograd carries them. `plain` routes the per-row
    CE through the plain versions of the kernels on any device."""
    bsz, length, dim = hidden.shape
    flat = real.reshape(-1)
    h = hidden.reshape(-1, dim)
    ce = softmax_xent(h, W, b, flat, plain).reshape(bsz, length)
    if label_smoothing:
        h32, W32, b32 = h.float(), W.float(), b.float()
        gold = (h32 * W32[flat]).sum(dim=-1) + b32[flat]
        mean_logits = h32 @ W32.mean(dim=0) + b32.mean()
        ce = ce + label_smoothing * (gold - mean_logits).reshape(bsz, length)
    return global_mean(torch.mean(ce * loss_mask(real, pad_idx,
                                                 extra_masked_ids)))
