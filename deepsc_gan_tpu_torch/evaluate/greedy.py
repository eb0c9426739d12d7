"""Greedy decoding over a fixed output buffer (JAX package
`evaluate/greedy.py:49-148`).

Every sequence starts with <START>; the channel decoder runs once; then for
each of max_length steps the combined causal + pad mask is rebuilt over the
(B, max_length+1) buffer, the semantic decoder runs over the whole buffer,
and the argmax of the vocab projection of one position becomes token i+1.
Future positions hold <PAD>, so the masks reproduce the reference's
growing-prefix decode exactly. `position_mode` says which position:
- "step" (the vanilla decoder, the default): position i at step i;
- "last": the reference's `[:, -1:]` read, the last position of the
  decoder's output at every step (on a star decoder, whose output has the
  memory's length, always the same position);
- "oneshot" (the star decoders): no loop; one decoder pass over the buffer
  of <START> and <PAD>, the f32 vocab projection of every position and the
  argmax of each: a star decoder's position i predicts token i from the
  channel signal.

The sweep decodes S noise levels at once. JAX vmaps the decode over the
noise levels; here the S x B rows are one batch written out. The encoder
does not depend on the noise level, so it runs once on the B input rows
(as under vmap) and every noise level shares its power normalization.
`single_level` and `noise_sweep` wrap a decoder loop (this module's, the
KV decoder's, beam search's) into the one-level and the sweep entry points.
`make_greedy_decode_attack` decodes at one noise level through a channel
that carries an FGM perturbation; `make_greedy_decode_gan` does the same
and also returns the teacher-forced clean argmax.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepsc_gan_tpu_torch.ops.masks import (
    create_look_ahead_mask,
    create_masks,
    create_padding_mask,
)
from deepsc_gan_tpu_torch.train.attacks import fgm_normalize
from deepsc_gan_tpu_torch.train.steps import logits_loss_of_y
from deepsc_gan_tpu_torch.utils.config import Config


POSITION_MODES = ("step", "last", "oneshot")


def _decode_loop(model, mem, enc_padding_mask, max_length: int,
                 start_idx: int, pad_idx: int,
                 position_mode: str = "step") -> torch.Tensor:
    """-> (N, max_length+1) int32 ids decoded from memory `mem` (N, L, D)
    (for "oneshot", the first max_length+1 of the decoder's positions)."""
    if position_mode not in POSITION_MODES:
        raise ValueError(f"position_mode {position_mode!r}: one of "
                         f"{POSITION_MODES}")
    n = mem.shape[0]
    buf = torch.full((n, max_length + 1), pad_idx, dtype=torch.long,
                     device=mem.device)
    buf[:, 0] = start_idx
    causal = create_look_ahead_mask(max_length + 1, mem.device)

    def decode():
        combined = torch.maximum(create_padding_mask(buf, pad_idx), causal)
        return model._semantic_decode(buf, mem, combined, enc_padding_mask,
                                      apply_final=False)

    if position_mode == "oneshot":
        ids = torch.argmax(model.final_projection(decode()), dim=-1)
        return ids[:, :max_length + 1].to(torch.int32)
    for i in range(max_length):
        h = decode()
        pos = i if position_mode == "step" else h.shape[1] - 1
        logits = model.final_projection(h[:, pos:pos + 1, :])[:, 0]
        buf[:, i + 1] = torch.argmax(logits, dim=-1)
    return buf.to(torch.int32)


def single_level(model, cfg: Config, loop: Callable) -> Callable:
    """-> `decode(inp, pnr_db, n_std, noise, fade=None) -> (B, max_length+1)
    ids`: encode, the channel at one noise level with its standard-normal
    draws `noise` (B, L, channel_dim) and, for a fading cfg.channel, `fade`
    ((2,), or (B, 1, 2) per sample), channel decode, then
    `loop(mem, enc_padding_mask)` (the greedy, KV or beam decoder)."""

    @torch.inference_mode()
    def decode(inp, pnr_db, n_std, noise, fade=None):
        enc_padding_mask = create_padding_mask(inp, cfg.pad_idx)
        tx = model.encode(inp, enc_padding_mask)
        y = model.transmit(tx, noise, n_std, pnr_db=pnr_db, fade=fade)
        return loop(model.channel_decode(y), enc_padding_mask)

    return decode


def noise_sweep(model, cfg: Config, loop: Callable) -> Callable:
    """-> `sweep(inp, pnr_db, n_stds[S], noise[S, B, L, channel_dim],
    fade=None) -> (S, B, max_length+1) ids`: the encoder once on the B rows,
    the channel at S noise levels (for a fading cfg.channel, one fade draw
    per level: `fade` (S, 2), or (S, B, 1, 2) per sample), then `loop` once
    on the S x B rows folded noise-level-major into one batch."""

    @torch.inference_mode()
    def sweep(inp, pnr_db, n_stds, noise, fade=None):
        s, b = n_stds.shape[0], inp.shape[0]
        enc_padding_mask = create_padding_mask(inp, cfg.pad_idx)
        tx = model.encode(inp, enc_padding_mask)
        y = model.transmit(tx[None], noise, n_stds.reshape(s, 1, 1, 1),
                           pnr_db=pnr_db, fade=fade)
        mem = model.channel_decode(y.reshape((s * b,) + tx.shape[1:]))
        ids = loop(mem, enc_padding_mask.repeat(s, 1, 1, 1))
        return ids.reshape(s, b, -1)

    return sweep


def _greedy_loop(model, cfg: Config, position_mode: str) -> Callable:
    return lambda mem, mask: _decode_loop(model, mem, mask, cfg.max_length,
                                          cfg.start_idx, cfg.pad_idx,
                                          position_mode)


def make_greedy_decode(model, cfg: Config,
                       position_mode: str = "step") -> Callable:
    """Clean greedy decode at one noise level:
    `decode(inp, pnr_db, n_std, noise) -> (B, max_length+1) ids`, with
    `noise` the channel's standard-normal draw shaped like the transmitted
    symbols (B, L, channel_dim)."""
    return single_level(model, cfg, _greedy_loop(model, cfg, position_mode))


def make_greedy_decode_sweep(model, cfg: Config,
                             position_mode: str = "step") -> Callable:
    """Clean greedy decode across S noise levels in one call:
    `sweep(inp, pnr_db, n_stds[S], noise[S, B, L, channel_dim])
    -> (S, B, max_length+1) ids`."""
    return noise_sweep(model, cfg, _greedy_loop(model, cfg, position_mode))


def make_greedy_decode_attack(model, cfg: Config,
                              position_mode: str = "step",
                              full_target: bool = False) -> Callable:
    """FGM-attacked greedy decode at one noise level (the reference's
    `greedy_decode`; JAX `make_greedy_decode_attack`) through cfg.channel:
    a teacher-forced pass on the input itself through channel draw 1, the
    gradient of its loss with respect to the received y, the FGM
    perturbation injected into channel draw 2, then the decoder loop
    (`position_mode`; "oneshot" for a star codec). `full_target` scores the
    gradient's loss against the un-shifted input (the star decoders).
    -> `decode(inp, pnr_db, n_std, noise, fade=None, epsilon=1.0) ->
    (B, max_length+1) ids`, with the two draws stacked: noise
    (2, B, L, channel_dim), and for a fading channel fade (2, 2) or
    (2, B, 1, 2)."""

    return _fgm_decode(model, cfg, position_mode, full_target, False)


def make_greedy_decode_gan(model, cfg: Config, position_mode: str = "step",
                           full_target: bool = False) -> Callable:
    """The GAN model's greedy decode (the reference's `greedy_decode_gan`;
    JAX `make_greedy_decode_gan`): `make_greedy_decode_attack`'s decode,
    the gradient taken on the clean reception of channel draw 1, which also
    gives `noa`, the teacher-forced clean argmax ((B, L - 1) int32; (B, L)
    with `full_target`, the star decoders, which decode in one shot). ->
    `decode(inp, pnr_db, n_std, noise, fade=None, epsilon=1.0) -> (ids,
    noa)`, the draws stacked as for `make_greedy_decode_attack`."""
    return _fgm_decode(model, cfg, position_mode, full_target, True)


def _fgm_decode(model, cfg: Config, position_mode: str, full_target: bool,
                with_noa: bool) -> Callable:

    @torch.no_grad()
    def decode(inp, pnr_db, n_std, noise, fade=None, epsilon=1.0):
        f1, f2 = (None, None) if fade is None else (fade[0], fade[1])
        tar_inp = inp[:, :-1]
        tar_real = inp if full_target else inp[:, 1:]
        enc_padding_mask, combined_mask, dec_mask = create_masks(
            inp, tar_inp, cfg.pad_idx)
        scored = logits_loss_of_y(model, cfg, tar_inp, tar_real,
                                  combined_mask, dec_mask)
        tx = model.encode(inp, enc_padding_mask)
        y1 = model.transmit(tx, noise[0], n_std, None, pnr_db,
                            fade=f1).requires_grad_(True)
        with torch.enable_grad():
            loss, logits = scored(y1)
            (g,) = torch.autograd.grad(loss, y1)
        y = model.transmit(tx, noise[1], n_std, fgm_normalize(g, epsilon),
                           pnr_db, fade=f2)
        ids = _decode_loop(model, model.channel_decode(y), enc_padding_mask,
                           cfg.max_length, cfg.start_idx, cfg.pad_idx,
                           position_mode)
        if not with_noa:
            return ids
        return ids, torch.argmax(logits, dim=-1).to(torch.int32)

    return decode
