"""The GAN three-phase train step and the GAN evaluation step (JAX package
`train/gan_steps.py`, the reference's `gan_train_step`).

One forward of the GAN transceiver (the generator's perturbation G(tx) on
branch p at cfg.gan_pnr_db, a clean branch r) and three losses:
    loss   = CE(pred_r)                             (the clean receiver)
    g_loss = cfg.g_loss_ceiling - CE(pred_p)        (the generator)
    d_loss = lambda CE(pred_r) + (1 - lambda) CE(pred_p)   (the receiver)
then three updates from ONE shared Adam, each gradient taken at the
parameters before any update, as JAX takes them:
    phase 1: every parameter but the generator's   <- grad loss
    phase 2: the generator's                       <- grad g_loss
    phase 3: the receiver side (all but the generator, the semantic
             encoder and the channel encoder)      <- grad d_loss
The gradients are linear in two: grad CE_r (over every parameter but the
generator's) and grad CE_p (over the generator's and the receiver side's
only, so the encoder's backward runs once), so the step takes two backward
passes, not three.

The shared Adam (`selective_update`): optax keeps one count for Adam's bias
correction and the schedule, and it goes up at every phase, three times a
step; a parameter outside a phase keeps its value and its moments
(`_merge_opt_state`'s semantics) while the count moves on. `torch.optim.Adam`
keeps a `step` per parameter and skips a parameter without a gradient, so
each phase sets every participating parameter's `step` to the shared count
(creating its moments at zero on its first phase) and reads the learning
rate at that count; the others get no gradient and are left as they are.
The EMA shadow advances once per full step.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from deepsc_gan_tpu_torch.ops.fused_ce import fused_ce_loss
from deepsc_gan_tpu_torch.ops.losses import loss_function
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.ops.schedule import set_lr
from deepsc_gan_tpu_torch.parallel.batch import sync_grads
from deepsc_gan_tpu_torch.train.attacks import fgm_normalize
from deepsc_gan_tpu_torch.train.steps import (
    TrainState,
    _draw,
    _eval_parts,
    _final_wb,
    _loss_kwargs,
    _shift_targets,
    logits_loss_of_y,
)
from deepsc_gan_tpu_torch.utils.config import Config

GENERATOR = "generator"
TX_SIDE = ("generator", "semantic_encoder", "channel_encoder")


def phase_mask(model: torch.nn.Module, include: Optional[Iterable] = None,
               exclude: Optional[Iterable] = None) -> Dict[str, bool]:
    """Parameter name -> whether the phase updates it, by its top-level
    module: those in `include` when given, else those not in `exclude`."""

    def sel(name):
        top = name.split(".")[0]
        if include is not None:
            return top in include
        return top not in (exclude or ())

    return {n: sel(n) for n, _ in model.named_parameters()}


def selective_update(state: TrainState, grads: Dict[str, torch.Tensor],
                     mask: Dict[str, bool]) -> None:
    """One update of the shared Adam in place, of the parameters `mask`
    selects, with their `grads` (a missing one counts as zero, as JAX's
    gradient of an unused leaf is): the learning rate and every
    participating parameter's bias correction at the shared count
    `state.step`, which then goes up by one. The other parameters keep
    their values and moments. Under a data-parallel shard the gradients
    are first averaged over its group."""
    count = state.step
    opt = state.optimizer
    set_lr(opt, state.schedule(count))
    for name, p in state.model.named_parameters():
        if not mask[name]:
            p.grad = None
            continue
        g = grads.get(name)
        p.grad = torch.zeros_like(p) if g is None else g
        st = opt.state[p]
        if not st:
            st["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        if "step" not in st:  # on the parameter's device when capturable
            st["step"] = torch.zeros(
                (), dtype=torch.float32,
                device=p.device if opt.defaults["capturable"] else None)
        st["step"].fill_(float(count))
    sync_grads(p.grad for name, p in state.model.named_parameters()
               if mask[name])
    opt.step()
    state.step += 1


def _ema(state: TrainState) -> None:
    if state.ema is None:
        return
    d = state.ema_decay
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            state.ema[name].mul_(d).add_(p, alpha=1.0 - d)


def make_gan_train_step(model: torch.nn.Module, cfg: Config,
                        full_target: bool = False,
                        plain: bool = False) -> Callable:
    """-> `step(state, inp, tar, gen, n_std, noise_p=None, noise_r=None,
    fade_p=None, fade_r=None) -> (state, (loss, g_loss, d_loss))`: one
    three-phase update in place (see the module docstring). The branches'
    channel draws (noise, then a fading channel's fade; branch p's first)
    come from `gen` when not given, then the dropout masks. `n_std` is used
    as given. The losses are scored through the fused CE (`plain`: its
    plain versions) when cfg.fused_ce, else on materialized logits;
    `full_target` scores against the un-shifted target (gan_star). The
    reference's random input perturbation is not drawn: with the generator
    on, it never reaches the forward."""
    lkw = _loss_kwargs(cfg)
    lam = cfg.gan_lambda
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    codec = phase_mask(model, exclude=(GENERATOR,))
    gen_only = phase_mask(model, include=(GENERATOR,))
    receiver = phase_mask(model, exclude=TX_SIDE)
    r_names = [n for n in names if codec[n]]
    p_names = [n for n in names if gen_only[n] or receiver[n]]

    def score(out, tar_real):
        if cfg.fused_ce:
            W, b = _final_wb(model)
            return fused_ce_loss(out, W, b, tar_real, plain=plain, **lkw)
        return loss_function(tar_real, out, **lkw)

    def grads(loss, wanted, retain):
        got = torch.autograd.grad(loss, [params[n] for n in wanted],
                                  retain_graph=retain, allow_unused=True)
        return dict(zip(wanted, got))

    def combine(g_r, g_p):
        """lambda g_r + (1 - lambda) g_p, a missing gradient as zero."""
        terms = [w * g for w, g in ((lam, g_r), (1.0 - lam, g_p))
                 if g is not None]
        return sum(terms) if terms else None

    def step(state: TrainState, inp, tar, gen, n_std, noise_p=None,
             noise_r=None, fade_p=None, fade_r=None):
        tar_inp, tar_shift = _shift_targets(tar)
        tar_real = tar if full_target else tar_shift
        enc_mask, combined_mask, dec_mask = create_masks(inp, tar_inp,
                                                         cfg.pad_idx)
        if noise_p is None:
            noise_p, fade_p = _draw(cfg, gen, inp, cfg.channel)
            noise_r, fade_r = _draw(cfg, gen, inp, cfg.channel)
        out_p, out_r, _, _ = model(
            inp, tar_inp, noise_p, noise_r, n_std, None, cfg.gan_pnr_db,
            enc_mask, combined_mask, dec_mask, gen, traingan=True,
            fade_p=fade_p, fade_r=fade_r, apply_final=not cfg.fused_ce)
        loss = score(out_r, tar_real)
        ce_p = score(out_p, tar_real)
        g_r = grads(loss, r_names, True)
        g_p = grads(ce_p, p_names, False)
        selective_update(state, g_r, codec)
        selective_update(state, {n: None if g_p[n] is None else -g_p[n]
                                 for n in p_names if gen_only[n]}, gen_only)
        selective_update(state, {n: combine(g_r.get(n), g_p[n])
                                 for n in p_names if receiver[n]}, receiver)
        _ema(state)
        with torch.no_grad():
            g_loss = cfg.g_loss_ceiling - ce_p
            d_loss = lam * loss + (1.0 - lam) * ce_p
        return state, (loss.detach(), g_loss, d_loss)

    return step


def make_gan_eval_step(model: torch.nn.Module, cfg: Config,
                       full_target: bool = False) -> Callable:
    """The GAN model's FGM evaluation (JAX `make_gan_eval_step`, the
    reference's `eval_step` / `eval_step_FGM`), deterministic: the clean
    forward through channel draw 1, the gradient of its loss with respect
    to the clean received y_r, `fgm_normalize` of it, and the perturbed
    forward (the perturbation at `pnr_db`, the generator off) through
    channel draw 2; the logits materialized (B, L, V) in f32 and the losses
    taken from them. -> `step(inp, tar, gen, pnr_db, n_std, epsilon,
    draws=None) -> (clean_loss, attacked_loss, clean_logits,
    attacked_logits)`; `draws` are two (noise, fade) channel draws, from
    `gen` when not given. The clean logits come from the gradient's own
    forward, and the clean branch of the perturbed forward, which no output
    reads, is not run (JAX's compiler drops it too)."""
    kind = cfg.channel

    @torch.no_grad()
    def step(inp, tar, gen, pnr_db, n_std, epsilon, draws=None):
        tar_inp, tar_real, _, combined_mask, dec_mask, tx = _eval_parts(
            model, cfg, full_target, inp, tar)
        if draws is None:
            draws = (_draw(cfg, gen, inp, kind), _draw(cfg, gen, inp, kind))
        (n1, f1), (n2, f2) = draws
        scored = logits_loss_of_y(model, cfg, tar_inp, tar_real,
                                  combined_mask, dec_mask)
        y_r = model.transmit(tx, n1, n_std, None, pnr_db,
                             fade=f1).requires_grad_(True)
        with torch.enable_grad():
            clean_loss, clean_logits = scored(y_r)
            (g_y,) = torch.autograd.grad(clean_loss, y_r)
        pert = fgm_normalize(g_y, epsilon)
        attacked_loss, attacked_logits = scored(model.transmit(
            tx, n2, n_std, pert, pnr_db, fade=f2))
        return (clean_loss.detach(), attacked_loss, clean_logits.detach(),
                attacked_logits)

    return step
