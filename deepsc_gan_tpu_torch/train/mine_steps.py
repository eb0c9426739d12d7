"""MINE joint training (JAX package `train/mine_steps.py`), DeepSC's
second-phase recipe: the statistics network T (`models/mine.py`) raises
the bound MI(tx; y) >= E[T(tx, y)] - log E[e^T(tx, y_shuffled)], and the
transceiver's loss gains `- mine_lambda * MI` so the codec learns symbols
that keep mutual information across the channel.

One step, in the JAX step's order:
1. the target is shifted (always: the JAX step scores the shifted
   target, so only the vanilla decoder's output lines up with it, and
   `cli train --train-mode mine` takes `--variant transformer` alone);
   the channel is cfg.channel with no perturbation (PNR 0 dB);
2. the transceiver is updated on `ce - mine_lambda * mi` with T's
   parameters held fixed: the gradient reaches the transceiver through
   tx and y, T's input. The CE is `loss_function` on materialized f32
   logits, as the JAX step computes it (no K3/K4 on this path);
3. T is updated on `-mi`, recomputed with the UPDATED transceiver and the
   SAME channel draw, dropout masks and permutation. mi depends on tx and
   y alone, so only encode -> transmit runs again, without autograd for
   the transceiver; the generator's state is saved before phase 2's
   dropout draws and set back for the recompute (as
   `make_train_attack_step` replays its masks), then set to where phase 2
   left it.

T's optimizer is optax's `chain(clip_by_global_norm(1.0), adam(1e-3))`:
the gradients are scaled by max_norm / norm only when their global norm
is at least max_norm (optax's form, not `clip_grad_norm_`'s
max_norm / (norm + 1e-6)), then Adam (0.9, 0.999, 1e-8); on CUDA the
capturable fused Adam of `ops/schedule.py`.

Randomness comes from the step's `torch.Generator`: the channel draw, then
the marginal permutation, then the dropout masks in forward order. A
caller may pass the draws and the permutation, as the parity tests do with
JAX's. Under a data-parallel shard (`parallel/batch.py`) the permutation is
the global batch's, and the bound and T's gradients the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch
from torch import nn

from deepsc_gan_tpu_torch.models.mine import MINE, mine_loss
from deepsc_gan_tpu_torch.ops.losses import loss_function
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.ops.schedule import make_optimizer
from deepsc_gan_tpu_torch.parallel.batch import (
    dp_group,
    global_rows,
    sync_grads,
)
from deepsc_gan_tpu_torch.train.steps import (
    TrainState,
    _draw,
    _loss_kwargs,
    _shift_targets,
    init_params,
)
from deepsc_gan_tpu_torch.utils.config import Config

MAX_NORM = 1.0


@dataclass
class MineState:
    """T's optimizer (Adam over T's parameters) and its update count."""

    optimizer: torch.optim.Adam
    step: int = 0


def clip_by_global_norm_(params: Iterable[nn.Parameter],
                         max_norm: float = MAX_NORM) -> torch.Tensor:
    """optax's `clip_by_global_norm` on the parameters' gradients, in
    place: every gradient g becomes g / norm * max_norm when the global
    norm sqrt(sum g^2) is at least max_norm, else stays. -> the norm (a
    device tensor: nothing waits for the device)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def create_mine_state(cfg: Config, seed: int = 0, lr: float = 1e-3,
                      device=None) -> tuple:
    """-> (T, its MineState): `MINE` for the transceiver's symbols
    (B, seq_len, channel_dim), flax's initialisers drawn from `seed`
    (lecun_normal kernels, zero biases), on `device`, with Adam at `lr`."""
    mine = init_params(MINE(2 * cfg.seq_len * cfg.channel_dim), seed)
    mine = mine.to(device)
    optimizer, _ = make_optimizer(mine.parameters(), lr)
    return mine, MineState(optimizer)


def make_mine_train_step(model: nn.Module, mine: MINE,
                         cfg: Config) -> Callable:
    """-> `step(state, mine_state, inp, tar, gen, n_std, noise=None,
    perm=None, fade=None) -> (state, mine_state, (ce, mi))`: one MINE
    step in place (see the module docstring); `noise` (and a fading
    channel's `fade`) the channel's standard normals (B, L, channel_dim)
    and `perm` the marginal pairing's permutation of the batch, drawn from
    `gen` when not given. The returned ce and mi are phase 2's (the
    transceiver's loss before its update)."""
    lkw = _loss_kwargs(cfg)
    lam = cfg.mine_lambda
    mine_params = list(mine.parameters())

    def symbols(inp, enc_mask, noise, n_std, fade, gen):
        tx = model.encode(inp, enc_mask, gen)
        return tx, model.transmit(tx, noise, n_std, None, 0.0, fade=fade)

    def step(state: TrainState, mine_state: MineState, inp, tar, gen, n_std,
             noise=None, perm=None, fade=None):
        tar_inp, tar_real = _shift_targets(tar)
        enc_mask, combined_mask, dec_mask = create_masks(inp, tar_inp,
                                                         cfg.pad_idx)
        if noise is None:
            noise, fade = _draw(cfg, gen, inp, cfg.channel)
        if perm is None:
            perm = torch.randperm(global_rows(inp.shape[0]), generator=gen,
                                  device=inp.device)
        masks_state = gen.get_state()

        # the transceiver's update, T's parameters held fixed
        state.optimizer.zero_grad(set_to_none=True)
        for p in mine_params:
            p.requires_grad_(False)
        try:
            tx, y = symbols(inp, enc_mask, noise, n_std, fade, gen)
            logits = model.decode(tar_inp, y, combined_mask, dec_mask, gen)
            ce = loss_function(tar_real, logits, **lkw)
            _, mi = mine_loss(mine, tx, y, perm, dp_group())
            (ce - lam * mi).backward()
        finally:
            for p in mine_params:
                p.requires_grad_(True)
        state.apply_gradients()

        # T's update on the updated transceiver's symbols, same draws
        after = gen.get_state()
        gen.set_state(masks_state)
        with torch.no_grad():
            tx, y = symbols(inp, enc_mask, noise, n_std, fade, gen)
        gen.set_state(after)
        mine_state.optimizer.zero_grad(set_to_none=True)
        loss, _ = mine_loss(mine, tx, y, perm, dp_group())
        loss.backward()
        sync_grads(p.grad for p in mine_params)
        clip_by_global_norm_(mine_params)
        mine_state.optimizer.step()
        mine_state.step += 1
        return state, mine_state, (ce.detach(), mi.detach())

    return step
