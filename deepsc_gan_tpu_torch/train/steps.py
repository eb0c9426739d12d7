"""The plain teacher-forced train step (JAX package `train/steps.py`, the
reference's `train_step_noattack`): shift the target, build the masks, draw
the channel noise, encode -> AWGN -> decode, the masked CE (through the
online-softmax CE kernels when `cfg.fused_ce`), backward, Adam with the
schedule read at the pre-increment count, and the optional EMA shadow.

Randomness comes from the `torch.Generator` each step is given, in a fixed
order: the SNR draw (`train_snr_random`), the channel noise, then the
dropout masks in forward order. A caller may pass the noise instead, as
the parity tests do with the normals JAX draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from deepsc_gan_tpu_torch.ops.fused_ce import fused_ce_loss
from deepsc_gan_tpu_torch.ops.losses import loss_function
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.ops.schedule import Schedule, make_optimizer
from deepsc_gan_tpu_torch.utils.config import Config

# flax's lecun_normal: a normal truncated at 2 std, rescaled to unit
# variance (the std of the truncated unit normal)
_TRUNC_STD = 0.87962566103423978


@dataclass
class TrainState:
    """The model (its parameters are the live params), Adam with its
    moments, the schedule, the update count, and the optional EMA shadow
    (parameter name -> tensor)."""

    model: nn.Module
    optimizer: torch.optim.Adam
    schedule: Schedule
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0

    def apply_gradients(self) -> None:
        """One Adam update from the gradients on the parameters, at the
        learning rate of the pre-increment count; then the EMA shadow
        (d * ema + (1 - d) * params)."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    self.ema[name].mul_(d).add_(p, alpha=1.0 - d)
        self.step += 1


def eval_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The parameters evaluation should use: the EMA shadow when enabled,
    else the live parameters (name -> tensor, a state_dict)."""
    if state.ema is not None:
        return state.ema
    return {n: p.detach() for n, p in state.model.named_parameters()}


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Flax's default initialisers, drawn on the CPU from `seed`: Dense
    weights lecun_normal (truncated normal, std 1/sqrt(fan_in)), biases 0,
    LayerNorm scale 1 and bias 0, embedding tables N(0, 1/d_model) (a tied
    decoder's final bias is created at 0)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            std = 1.0 / math.sqrt(m.in_features) / _TRUNC_STD
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           / math.sqrt(m.embedding_dim))
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


def create_train_state(model: nn.Module, cfg: Config) -> TrainState:
    """Adam (and its schedule) over the model's parameters, and the EMA
    shadow as a copy of them when cfg.ema_decay > 0."""
    opt, schedule = make_optimizer(model.parameters(), cfg.lr, cfg.schedule,
                                   cfg.encoder_d_model, cfg.warmup_steps,
                                   cfg.decay_steps)
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if cfg.ema_decay > 0.0 else None)
    return TrainState(model, opt, schedule, ema=ema, ema_decay=cfg.ema_decay)


def _shift_targets(tar):
    return tar[:, :-1], tar[:, 1:]


def _step_noise(cfg: Config, gen: torch.Generator, n_std, device):
    """The step's noise std: `n_std`, or with cfg.train_snr_random a draw
    SNR ~ U(lo, hi) dB as 10^(-SNR/20), taken with probability
    cfg.train_snr_mix (else n_std)."""
    if not cfg.train_snr_random:
        return n_std
    u = torch.rand((), generator=gen, device=device)
    snr = cfg.train_snr_lo + (cfg.train_snr_hi - cfg.train_snr_lo) * u
    drawn = 10.0 ** (-snr / 20.0)
    if cfg.train_snr_mix >= 1.0:
        return drawn
    use = torch.rand((), generator=gen, device=device) < cfg.train_snr_mix
    return torch.where(use, drawn, torch.as_tensor(
        n_std, dtype=torch.float32, device=device))


def _loss_kwargs(cfg: Config) -> dict:
    extra = (4, 5) if cfg.mask_extra_tokens else None
    return dict(pad_idx=cfg.pad_idx, extra_masked_ids=extra,
                label_smoothing=cfg.label_smoothing)


def _final_wb(model: nn.Module):
    """The vocab projection as (W (V, D), b (V,)): the tied decoder's
    embedding table and final bias, or the untied `final_layer`'s weight
    (already (V, D) in `nn.Linear`) and bias. No transposed copy is made;
    the CE kernels take this layout."""
    dec = model.semantic_decoder
    if dec.tie_embeddings:
        return dec.embed.embedding.weight, dec.final_bias
    return dec.final_layer.weight, dec.final_layer.bias


def make_forward_loss(model: nn.Module, cfg: Config, lkw: dict,
                      plain: bool = False) -> Callable:
    """Teacher-forced forward -> masked CE: hidden states into the fused
    CE (`plain`: its plain versions) when cfg.fused_ce, else materialized
    logits into `loss_function`."""

    def forward_loss(inp, tar_inp, tar_real, noise, n_std, enc_mask,
                     combined_mask, dec_mask, gen):
        tx = model.encode(inp, enc_mask, gen)
        y = model.transmit(tx, noise, n_std)
        if cfg.fused_ce:
            hidden = model.decode_loss_ready(tar_inp, y, combined_mask,
                                             dec_mask, gen)
            W, b = _final_wb(model)
            return fused_ce_loss(hidden, W, b, tar_real, plain=plain, **lkw)
        logits = model.decode(tar_inp, y, combined_mask, dec_mask, gen)
        return loss_function(tar_real, logits, **lkw)

    return forward_loss


def make_train_step(model: nn.Module, cfg: Config, plain: bool = False,
                    full_target: bool = False) -> Callable:
    """-> `step(state, inp, tar, gen, n_std, noise=None) -> (state, loss)`:
    one plain teacher-forced update in place (PNR 0, no perturbation). The
    gradients stay on the parameters until the next step. `noise` is the
    channel's standard normal (B, L, channel_dim), drawn from `gen` when
    not given. `plain` takes the CE through its plain versions (the
    attention's and the satellite update's are chosen when the model is
    built). `full_target` scores against the un-shifted target, as the star
    decoders need (their output has the memory's length); the decoder
    still reads the shifted `tar[:, :-1]`."""
    lkw = _loss_kwargs(cfg)
    forward_loss = make_forward_loss(model, cfg, lkw, plain)

    def step(state: TrainState, inp, tar, gen, n_std, noise=None):
        tar_inp, tar_real = _shift_targets(tar)
        if full_target:
            tar_real = tar
        enc_mask, combined_mask, dec_mask = create_masks(inp, tar_inp,
                                                         cfg.pad_idx)
        n_std_t = _step_noise(cfg, gen, n_std, inp.device)
        if noise is None:
            noise = torch.randn((inp.shape[0], inp.shape[1], cfg.channel_dim),
                                generator=gen, device=inp.device)
        state.optimizer.zero_grad(set_to_none=True)
        loss = forward_loss(inp, tar_inp, tar_real, noise, n_std_t, enc_mask,
                            combined_mask, dec_mask, gen)
        loss.backward()
        state.apply_gradients()
        return state, loss.detach()

    return step
