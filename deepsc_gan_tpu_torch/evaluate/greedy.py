"""Greedy autoregressive decoding over a fixed output buffer (JAX package
`evaluate/greedy.py:49-148`, position mode "step").

Every sequence starts with <START>; the channel decoder runs once; then for
each of max_length steps the combined causal + pad mask is rebuilt over the
(B, max_length+1) buffer, the semantic decoder runs over the whole buffer,
and the argmax of the vocab projection of position i becomes token i+1.
Future positions hold <PAD>, so the masks reproduce the reference's
growing-prefix decode exactly.

The sweep decodes S noise levels at once. JAX vmaps the decode over the
noise levels; here the S x B rows are one batch written out. The encoder
does not depend on the noise level, so it runs once on the B input rows
(as under vmap) and every noise level shares its power normalization.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepsc_gan_tpu_torch.ops.masks import (
    create_look_ahead_mask,
    create_padding_mask,
)
from deepsc_gan_tpu_torch.utils.config import Config


def _decode_loop(model, mem, enc_padding_mask, max_length: int,
                 start_idx: int, pad_idx: int) -> torch.Tensor:
    """-> (N, max_length+1) int32 ids decoded from memory `mem` (N, L, D)."""
    n = mem.shape[0]
    buf = torch.full((n, max_length + 1), pad_idx, dtype=torch.long,
                     device=mem.device)
    buf[:, 0] = start_idx
    causal = create_look_ahead_mask(max_length + 1, mem.device)
    for i in range(max_length):
        combined = torch.maximum(create_padding_mask(buf, pad_idx), causal)
        h = model._semantic_decode(buf, mem, combined, enc_padding_mask,
                                   apply_final=False)
        logits = model.final_projection(h[:, i:i + 1, :])[:, 0]
        buf[:, i + 1] = torch.argmax(logits, dim=-1)
    return buf.to(torch.int32)


def make_greedy_decode(model, cfg: Config) -> Callable:
    """Clean greedy decode at one noise level:
    `decode(inp, pnr_db, n_std, noise) -> (B, max_length+1) ids`, with
    `noise` the channel's standard-normal draw shaped like the transmitted
    symbols (B, L, channel_dim)."""

    @torch.inference_mode()
    def decode(inp, pnr_db, n_std, noise):
        enc_padding_mask = create_padding_mask(inp, cfg.pad_idx)
        tx = model.encode(inp, enc_padding_mask)
        y = model.transmit(tx, noise, n_std, pnr_db=pnr_db)
        mem = model.channel_decode(y)
        return _decode_loop(model, mem, enc_padding_mask, cfg.max_length,
                            cfg.start_idx, cfg.pad_idx)

    return decode


def make_greedy_decode_sweep(model, cfg: Config) -> Callable:
    """Clean greedy decode across S noise levels in one call:
    `sweep(inp, pnr_db, n_stds[S], noise[S, B, L, channel_dim])
    -> (S, B, max_length+1) ids`."""

    @torch.inference_mode()
    def sweep(inp, pnr_db, n_stds, noise):
        s, b = n_stds.shape[0], inp.shape[0]
        enc_padding_mask = create_padding_mask(inp, cfg.pad_idx)
        tx = model.encode(inp, enc_padding_mask)
        y = model.transmit(tx[None], noise, n_stds.reshape(s, 1, 1, 1),
                           pnr_db=pnr_db)
        mem = model.channel_decode(y.reshape((s * b,) + tx.shape[1:]))
        ids = _decode_loop(model, mem, enc_padding_mask.repeat(s, 1, 1, 1),
                           cfg.max_length, cfg.start_idx, cfg.pad_idx)
        return ids.reshape(s, b, -1)

    return sweep
