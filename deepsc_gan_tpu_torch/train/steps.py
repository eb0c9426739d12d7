"""The train and eval steps (JAX package `train/steps.py`): the plain
teacher-forced step (the reference's `train_step_noattack`), the FGM
adversarial step (`train_attack_step`), and the teacher-forced eval steps
with an FGM or PGD attack. A train step shifts the target, builds the
masks, draws the channel, runs encode -> channel -> decode, the masked CE
(through the online-softmax CE kernels when `cfg.fused_ce`), backward, Adam
with the schedule read at the pre-increment count, and the optional EMA
shadow.

Randomness comes from the `torch.Generator` each step is given, in a fixed
order: the SNR draw (`train_snr_random`), the channel (its noise, then for
a fading channel its fade), then the dropout masks in forward order. A
caller may pass the draws instead, as the parity tests do with the normals
JAX draws.

Run inside `parallel/batch.py:sharded` (as `parallel/sharding.py`'s
data-parallel steps run them), a step takes a rank's rows: its draws are
the global batch's rows for the rank, its batch-wide statistics and loss
means the global batch's, and its gradients are averaged over the group
before the update.

`make_train_multi_step` runs K plain steps a call, the counterpart of the
JAX package's `lax.scan` over K steps: on the CPU K eager steps, on CUDA
K replays of one captured CUDA graph of the step (`train/graphed.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from deepsc_gan_tpu_torch.models.channel import draw_channel, f32_scalar
from deepsc_gan_tpu_torch.models.gan import Conv1dSame
from deepsc_gan_tpu_torch.ops.fused_ce import fused_ce_loss
from deepsc_gan_tpu_torch.ops.losses import loss_function
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.ops.schedule import Schedule, make_optimizer, set_lr
from deepsc_gan_tpu_torch.parallel.batch import dp_group, sync_grads
from deepsc_gan_tpu_torch.train.attacks import (
    fgm_normalize,
    fgm_perturbation,
    pgd_bisection,
)
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

    def set_lr(self) -> None:
        """The learning rate at the pre-increment count, into the
        optimizer (on CUDA a fill of its device tensor)."""
        set_lr(self.optimizer, self.schedule(self.step))

    def update(self) -> None:
        """One Adam update from the gradients on the parameters at the rate
        `set_lr` wrote (under a data-parallel shard, first averaged over
        its group: `parallel/batch.py:sync_grads`); then the EMA shadow
        (d * ema + (1 - d) * params). Device work alone, so a captured
        graph may hold it."""
        sync_grads(p.grad for p in self.model.parameters())
        self.optimizer.step()
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    self.ema[name].mul_(d).add_(p, alpha=1.0 - d)

    def apply_gradients(self) -> None:
        """`set_lr`, `update`, and the count up by one."""
        self.set_lr()
        self.update()
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
    and conv weights lecun_normal (truncated normal, std 1/sqrt(fan_in)),
    biases 0, LayerNorm scale 1 and bias 0, embedding tables
    N(0, 1/d_model) (a tied decoder's final bias is created at 0)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, Conv1dSame)):
            fan_in = m.weight[0].numel()
            std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
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
    kept = (f32_scalar(n_std, device) if isinstance(n_std, torch.Tensor)
            else torch.full((), n_std, dtype=torch.float32, device=device))
    return torch.where(use, drawn, kept)


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


def _draw(cfg: Config, gen: torch.Generator, inp, kind: str):
    """(noise, fade) of one channel use for the batch `inp`."""
    return draw_channel(gen, (inp.shape[0], inp.shape[1], cfg.channel_dim),
                        kind, cfg.fading_per_sample)


def make_forward_loss(model: nn.Module, cfg: Config, lkw: dict,
                      plain: bool = False) -> Callable:
    """Teacher-forced forward -> masked CE: hidden states into the fused
    CE (`plain`: its plain versions) when cfg.fused_ce, else materialized
    logits into `loss_function`. The channel is cfg.channel with the
    perturbation `p` at `pnr_db`."""
    loss_of_y = decode_loss(model, cfg, lkw, plain)

    def forward_loss(inp, tar_inp, tar_real, noise, n_std, enc_mask,
                     combined_mask, dec_mask, gen, p=None, pnr_db=0.0,
                     fade=None):
        tx = model.encode(inp, enc_mask, gen)
        y = model.transmit(tx, noise, n_std, p, pnr_db, fade=fade)
        return loss_of_y(y, tar_inp, tar_real, combined_mask, dec_mask, gen)

    return forward_loss


def decode_loss(model: nn.Module, cfg: Config, lkw: dict,
                plain: bool = False, fixed_table: bool = False) -> Callable:
    """-> `loss(y, tar_inp, tar_real, combined_mask, dec_mask, gen)`: the
    decoder from the received symbols y, then the masked CE as
    `make_forward_loss`. `fixed_table` passes the vocab table to the fused
    CE detached, so its backward forms dh alone (K4's dh-only mode): the
    attacks' gradient with respect to y."""

    def loss(y, tar_inp, tar_real, combined_mask, dec_mask, gen=None):
        if cfg.fused_ce:
            hidden = model.decode_loss_ready(tar_inp, y, combined_mask,
                                             dec_mask, gen)
            W, b = _final_wb(model)
            if fixed_table:
                W, b = W.detach(), b.detach()
            return fused_ce_loss(hidden, W, b, tar_real, plain=plain, **lkw)
        logits = model.decode(tar_inp, y, combined_mask, dec_mask, gen)
        return loss_function(tar_real, logits, **lkw)

    return loss


def logits_loss_of_y(model: nn.Module, cfg: Config, tar_inp, tar_real,
                     combined_mask, dec_mask) -> Callable:
    """-> `f(y) -> (loss, logits)`: the deterministic decoder from the
    received symbols y, its logits materialized (B, L, V) in f32 and the
    masked CE taken from them, as the JAX package's eval steps do. The
    eval steps and the attacked greedy decode score y with it."""
    lkw = _loss_kwargs(cfg)

    def f(y):
        logits = model.decode(tar_inp, y, combined_mask, dec_mask)
        return loss_function(tar_real, logits, **lkw), logits

    return f


def make_train_step(model: nn.Module, cfg: Config, plain: bool = False,
                    full_target: bool = False) -> Callable:
    """-> `step(state, inp, tar, gen, n_std, noise=None, fade=None) ->
    (state, loss)`: one plain teacher-forced update in place (PNR 0, no
    perturbation). The gradients stay on the parameters until the next
    step. `noise` is the channel's standard normal (B, L, channel_dim) and
    `fade` a fading channel's (models/channel.py), drawn from `gen` when
    not given. `plain` takes the CE through its plain versions (the
    attention's and the satellite update's are chosen when the model is
    built). `full_target` scores against the un-shifted target, as the star
    decoders need (their output has the memory's length); the decoder
    still reads the shifted `tar[:, :-1]`."""
    lkw = _loss_kwargs(cfg)
    forward_loss = make_forward_loss(model, cfg, lkw, plain)

    def forward_backward(state: TrainState, inp, tar, gen, n_std,
                         noise=None, fade=None):
        """The step's loss, its gradients left on the parameters."""
        tar_inp, tar_real = _shift_targets(tar)
        if full_target:
            tar_real = tar
        enc_mask, combined_mask, dec_mask = create_masks(inp, tar_inp,
                                                         cfg.pad_idx)
        n_std_t = _step_noise(cfg, gen, n_std, inp.device)
        if noise is None:
            noise, fade = _draw(cfg, gen, inp, cfg.channel)
        state.optimizer.zero_grad(set_to_none=True)
        loss = forward_loss(inp, tar_inp, tar_real, noise, n_std_t, enc_mask,
                            combined_mask, dec_mask, gen, fade=fade)
        loss.backward()
        return loss.detach()

    def step(state: TrainState, inp, tar, gen, n_std, noise=None,
             fade=None):
        loss = forward_backward(state, inp, tar, gen, n_std, noise, fade)
        state.apply_gradients()
        return state, loss

    step.forward_backward = forward_backward
    return step


def make_train_multi_step(model: nn.Module, cfg: Config,
                          full_target: bool = False) -> Callable:
    """K plain steps a call, the counterpart of the JAX package's
    `make_train_multi_step` (`lax.scan` over K steps, one dispatch). ->
    `multi_step(state, inps, tars, gen, n_std, noise=None) -> (state,
    losses (K,))`, inps and tars (K, B, L) stacks (`data/loader.py:
    stacked_batches`) and `noise` the channel's normals (K, B, L,
    channel_dim), drawn from `gen` when not given; the state is updated in
    place as K calls of `make_train_step`'s step would (`full_target` as
    there).

    On the CPU: K eager steps. On CUDA: the step captured once per shape as
    a CUDA graph after a warm-up step (the first step of the first call,
    run eagerly on a side stream), then replayed once per remaining step
    with the batch copied into the graph's static input. `gen` is
    registered with the graph, so each replay draws its channel noise and
    dropout masks from the generator's state at that point, the values an
    eager step would draw (`train/graphed.py`). One graph of one step, not
    of K: K replays cost K launches of the graph, and a call of any K takes
    the same graph. Its capture raises if it fails; nothing falls back to
    the eager step (`--scan-steps 1` is that). A new batch shape, or noise
    given where it was drawn, captures a graph of its own."""
    step = make_train_step(model, cfg, full_target=full_target)
    graphs = {}

    def multi_step(state: TrainState, inps, tars, gen, n_std, noise=None):
        k = inps.shape[0]
        per = [None] * k if noise is None else list(noise)
        if inps.device.type != "cuda":
            losses = []
            for i in range(k):
                state, loss = step(state, inps[i], tars[i], gen, n_std,
                                   per[i])
                losses.append(loss)
            return state, torch.stack(losses)
        from deepsc_gan_tpu_torch.train.graphed import GraphedStep, warm_up

        key = (tuple(inps.shape[1:]), tuple(tars.shape[1:]), noise is None)
        losses = torch.empty(k, dtype=torch.float32, device=inps.device)
        first = 0
        if key not in graphs:
            state, losses[0] = warm_up(step, state, inps[0], tars[0], gen,
                                       n_std, per[0])
            graphs[key] = GraphedStep(step.forward_backward, state, inps[0],
                                      tars[0], gen, n_std, per[0])
            first = 1
        graph = graphs[key]
        for i in range(first, k):
            losses[i] = graph.replay(state, inps[i], tars[i], gen, n_std,
                                     per[i])
        return state, losses

    multi_step.graphs = graphs
    return multi_step


def make_train_attack_step(model: nn.Module, cfg: Config,
                           full_target: bool = False,
                           adv_weight: float = 1.0,
                           plain: bool = False) -> Callable:
    """FGM adversarial step (the reference's `train_attack_step`; JAX
    `make_train_attack_step`). -> `step(state, inp, tar, gen, pnr_db, n_std,
    epsilon, noise1=None, noise2=None, fade1=None, fade2=None) -> (state,
    (clean_loss, adv_loss))`, one update in place.

    Phase 1: a forward with no perturbation through channel draw 1, then
    the gradient of its loss with respect to the received y1 alone (y1 a
    leaf, the vocab table fixed: K4 in its dh-only mode, no parameter
    gradient formed); r = fgm_normalize(g_y, epsilon). Phase 2: the forward
    with p = r at `pnr_db` through channel draw 2, and the update on
    `adv_weight * adv + (1 - adv_weight) * clean`, the clean forward taking
    the same channel draw and the same dropout masks as the adversarial one
    (the generator's state is saved and restored); with `adv_weight` >= 1
    (the reference) on the adversarial loss alone, and no clean forward
    runs. The draws come from `gen` when not given, in the order: draw 1,
    phase 1's dropout, draw 2, phase 2's dropout. `n_std` is used as given
    (no `train_snr_random` draw), and `full_target` scores the un-shifted
    target (the star decoders). The returned clean loss is phase 1's."""
    lkw = _loss_kwargs(cfg)
    forward_loss = make_forward_loss(model, cfg, lkw, plain)
    loss_of_y = decode_loss(model, cfg, lkw, plain, fixed_table=True)

    def step(state: TrainState, inp, tar, gen, pnr_db, n_std, epsilon,
             noise1=None, noise2=None, fade1=None, fade2=None):
        tar_inp, tar_shift = _shift_targets(tar)
        tar_real = tar if full_target else tar_shift
        enc_mask, combined_mask, dec_mask = create_masks(inp, tar_inp,
                                                         cfg.pad_idx)
        masks = (enc_mask, combined_mask, dec_mask)
        if noise1 is None:
            noise1, fade1 = _draw(cfg, gen, inp, cfg.channel)
        with torch.no_grad():
            tx = model.encode(inp, enc_mask, gen)
            y1 = model.transmit(tx, noise1, n_std, None, pnr_db, fade=fade1)
        y1.requires_grad_(True)
        clean = loss_of_y(y1, tar_inp, tar_real, combined_mask, dec_mask,
                          gen)
        (g_y,) = torch.autograd.grad(clean, y1)
        r = fgm_normalize(g_y, epsilon, dp_group())

        if noise2 is None:
            noise2, fade2 = _draw(cfg, gen, inp, cfg.channel)
        state.optimizer.zero_grad(set_to_none=True)
        masks_state = gen.get_state() if adv_weight < 1.0 else None
        adv = forward_loss(inp, tar_inp, tar_real, noise2, n_std, *masks,
                           gen, r, pnr_db, fade2)
        total = adv
        if adv_weight < 1.0:
            gen.set_state(masks_state)
            clean2 = forward_loss(inp, tar_inp, tar_real, noise2, n_std,
                                  *masks, gen, None, pnr_db, fade2)
            total = adv_weight * adv + (1.0 - adv_weight) * clean2
        total.backward()
        state.apply_gradients()
        return state, (clean.detach(), adv.detach())

    return step


def _eval_parts(model: nn.Module, cfg: Config, full_target: bool, inp, tar):
    """(tar_inp, tar_real, enc_mask, combined_mask, dec_mask, tx): the
    shifted target, the masks and the deterministic transmitted symbols."""
    tar_inp, tar_shift = _shift_targets(tar)
    tar_real = tar if full_target else tar_shift
    enc_mask, combined_mask, dec_mask = create_masks(inp, tar_inp,
                                                     cfg.pad_idx)
    with torch.no_grad():
        tx = model.encode(inp, enc_mask)
    return tar_inp, tar_real, enc_mask, combined_mask, dec_mask, tx


def make_eval_step(model: nn.Module, cfg: Config,
                   full_target: bool = False) -> Callable:
    """Teacher-forced eval with an FGM attack on the transmitted symbols
    (the reference's `eval_step_normal` / `eval_step_star`; JAX
    `make_eval_step` with its default "tx" target), deterministic.
    -> `step(inp, tar, gen, pnr_db, n_std, epsilon, draws=None) ->
    (clean_loss, attacked_loss, clean_logits, attacked_logits)`, the logits
    (B, L, V) f32 and the losses taken from them.

    `draws` are three (noise, fade) channel draws, from `gen` when not
    given: the clean forward takes draw 1; the attack gradient with respect
    to tx always goes through an AWGN pass, which reuses draw 1's noise on
    an AWGN channel and takes draw 2's noise on a fading one (draw 2 is
    then AWGN noise alone, and is not drawn for AWGN); the attacked forward
    takes draw 3. On a fading channel the perturbation does not reach the
    attacked forward (quirk Q3)."""
    kind = cfg.channel

    @torch.no_grad()
    def step(inp, tar, gen, pnr_db, n_std, epsilon, draws=None):
        tar_inp, tar_real, _, combined_mask, dec_mask, tx = _eval_parts(
            model, cfg, full_target, inp, tar)
        if draws is None:
            first = _draw(cfg, gen, inp, kind)
            grad = first if kind == "AWGN" else _draw(cfg, gen, inp, "AWGN")
            draws = (first, grad, _draw(cfg, gen, inp, kind))
        (n1, f1), (ng, _), (n3, f3) = draws
        if kind == "AWGN":
            ng = n1
        scored = logits_loss_of_y(model, cfg, tar_inp, tar_real,
                                  combined_mask, dec_mask)
        clean_loss, clean_logits = scored(model.transmit(
            tx, n1, n_std, None, pnr_db, fade=f1))
        pert, _ = fgm_perturbation(lambda t: scored(model.transmit(
            t, ng, n_std, None, pnr_db, "AWGN"))[0], tx, epsilon)
        attacked_loss, attacked_logits = scored(model.transmit(
            tx, n3, n_std, pert, pnr_db, fade=f3))
        return clean_loss, attacked_loss, clean_logits, attacked_logits

    return step


def make_eval_step_pgd(model: nn.Module, cfg: Config,
                       full_target: bool = False,
                       iters: int = 10) -> Callable:
    """PGD-style eval (the reference's `eval_step_normal_pgd`; JAX
    `make_eval_step_pgd`), deterministic: the FGM direction from the
    gradient with respect to the received y0 (draw 1), then `iters` steps
    of bisection on the attack strength (`pgd_bisection`) over attacked
    forwards that all take draw 2, and the attacked logits at the found
    eps*. -> `step(inp, tar, gen, pnr_db, n_std, epsilon, draws=None) ->
    (clean_loss, attacked_loss, clean_logits, attacked_logits, eps_star)`;
    `draws` are two (noise, fade) channel draws, from `gen` when not
    given."""

    @torch.no_grad()
    def step(inp, tar, gen, pnr_db, n_std, epsilon, draws=None):
        tar_inp, tar_real, _, combined_mask, dec_mask, tx = _eval_parts(
            model, cfg, full_target, inp, tar)
        if draws is None:
            draws = (_draw(cfg, gen, inp, cfg.channel),
                     _draw(cfg, gen, inp, cfg.channel))
        (n1, f1), (n2, f2) = draws
        scored = logits_loss_of_y(model, cfg, tar_inp, tar_real,
                                  combined_mask, dec_mask)

        def attacked(pert):
            return scored(model.transmit(tx, n2, n_std, pert, pnr_db,
                                         fade=f2))

        y0 = model.transmit(tx, n1, n_std, None, pnr_db, fade=f1)
        direction, _ = fgm_perturbation(lambda y: scored(y)[0], y0, epsilon)
        clean_loss, clean_logits = scored(y0)
        eps_star, attacked_loss = pgd_bisection(
            lambda pert: attacked(pert)[0], direction, clean_loss, iters)
        attacked_logits = attacked(eps_star * direction)[1]
        return (clean_loss, attacked_loss, clean_logits, attacked_logits,
                eps_star)

    return step
