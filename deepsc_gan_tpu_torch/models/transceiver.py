"""The DeepSC transceivers (JAX package `models/transceiver.py:44-187`):
the vanilla Transformer codec (`Transceiver`), the single-block star codec
(`TransceiverStar`, SE/SD) and the multi-layer one (`TransceiverStarMulti`,
SEncoder/SDecoder), each with the dense channel codec, as stages: `encode`
(tokens -> power-normalized channel symbols), `transmit` (symbols ->
received symbols through the channel), `channel_decode` (received symbols
-> decoder memory), `_semantic_decode`, `final_projection`, and for
training `decode` (received symbols -> logits) and `decode_loss_ready`
(received symbols -> decoder hidden states, for the fused vocab-projection
+ CE). A stage given a `torch.Generator` applies dropout with masks drawn
from it; without one it is deterministic.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from deepsc_gan_tpu_torch.models.channel import (
    ChannelDecoder,
    ChannelEncoder,
    channel,
)
from deepsc_gan_tpu_torch.models.star import SD, SE, SDecoder, SEncoder
from deepsc_gan_tpu_torch.models.transformer import Decoder, Encoder, Gen
from deepsc_gan_tpu_torch.ops.attention_kernel import fused_attention
from deepsc_gan_tpu_torch.ops.star_kernel import satellite_attention
from deepsc_gan_tpu_torch.utils.config import Config, torch_dtype


class _TransceiverBase(nn.Module):
    """The stage plumbing around a semantic codec (`encoder`, `decoder`)
    and the channel codec."""

    def __init__(self, cfg: Config, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.semantic_encoder = encoder
        self.semantic_decoder = decoder
        self.channel_encoder = ChannelEncoder(
            cfg.encoder_d_model, cfg.channel_hidden, cfg.channel_dim, dt)
        self.channel_decoder = ChannelDecoder(
            cfg.channel_dim, cfg.decoder_d_model, cfg.channel_dec_hidden, dt)

    def encode(self, inp, enc_padding_mask=None, gen: Gen = None):
        """tokens -> power-normalized channel symbols (B, L, channel_dim)."""
        return self.channel_encoder(
            self.semantic_encoder(inp, enc_padding_mask, gen))

    def transmit(self, tx, noise, n_std, p: Optional[torch.Tensor] = None,
                 pnr_db: float = 0.0, channel_kind: Optional[str] = None,
                 fade: Optional[torch.Tensor] = None):
        """tx -> received symbols y through the channel `channel_kind` (by
        default cfg.channel, with cfg.equalizer); `noise` and, for a fading
        channel, `fade` are standard normal (models/channel.py)."""
        kind = channel_kind or self.cfg.channel
        return channel(tx, noise, n_std, p, pnr_db, kind, fade,
                       self.cfg.equalizer)

    def channel_decode(self, y):
        """received symbols -> decoder memory."""
        return self.channel_decoder(y)

    def _semantic_decode(self, tar_inp, mem, combined_mask, dec_padding_mask,
                         apply_final: bool = True, gen: Gen = None):
        return self.semantic_decoder(tar_inp, mem, combined_mask,
                                     dec_padding_mask, apply_final, gen)

    def decode(self, tar_inp, y, combined_mask=None, dec_padding_mask=None,
               gen: Gen = None, apply_final: bool = True):
        """received symbols (+ the teacher-forced target prefix) -> vocab
        logits in f32."""
        return self._semantic_decode(tar_inp, self.channel_decode(y),
                                     combined_mask, dec_padding_mask,
                                     apply_final, gen)

    def decode_loss_ready(self, tar_inp, y, combined_mask=None,
                          dec_padding_mask=None, gen: Gen = None):
        """`decode` without the vocab projection: the decoder's hidden
        states (B, L, D) in the activation dtype."""
        return self.decode(tar_inp, y, combined_mask, dec_padding_mask, gen,
                           apply_final=False)

    def final_projection(self, x):
        return self.semantic_decoder.final_projection(x)


class Transceiver(_TransceiverBase):
    """The vanilla transceiver; `attention` is the per-call attention
    function of its layers."""

    def __init__(self, cfg: Config, attention: Callable = fused_attention):
        dt = torch_dtype(cfg.dtype)
        super().__init__(cfg, Encoder(
            cfg.encoder_num_layer, cfg.encoder_num_heads, cfg.encoder_d_model,
            cfg.encoder_d_ff, cfg.vocab_size, cfg.encoder_dropout,
            cfg.ffn_mode, dtype=dt, attention=attention), Decoder(
            cfg.decoder_num_layer, cfg.decoder_d_model, cfg.decoder_num_heads,
            cfg.decoder_d_ff, cfg.vocab_size, cfg.decoder_dropout,
            cfg.ffn_mode, tie_embeddings=cfg.tie_embeddings, dtype=dt,
            attention=attention))


class TransceiverStarMulti(_TransceiverBase):
    """The multi-layer star transceiver (reference `Transeiver_star`);
    `satellite` is the satellite-update function of its layers."""

    def __init__(self, cfg: Config,
                 satellite: Callable = satellite_attention):
        dt = torch_dtype(cfg.dtype)
        super().__init__(cfg, SEncoder(
            cfg.cycle_num, cfg.encoder_num_layer, cfg.encoder_num_heads,
            cfg.encoder_d_model, cfg.encoder_d_ff, cfg.vocab_size,
            cfg.encoder_dropout, cfg.ffn_mode, dtype=dt,
            satellite=satellite), SDecoder(
            cfg.cycle_num, cfg.decoder_num_layer, cfg.decoder_d_model,
            cfg.decoder_num_heads, cfg.decoder_d_ff, cfg.vocab_size,
            cfg.decoder_dropout, cfg.ffn_mode,
            tie_embeddings=cfg.tie_embeddings, dtype=dt,
            satellite=satellite))


class TransceiverStar(_TransceiverBase):
    """The single-block star transceiver (reference `Transeiver_Star`, the
    variant of `results/star_best_params.pkl`)."""

    def __init__(self, cfg: Config,
                 satellite: Callable = satellite_attention):
        dt = torch_dtype(cfg.dtype)
        super().__init__(cfg, SE(
            cfg.cycle_num, cfg.encoder_num_heads, cfg.encoder_d_model,
            cfg.encoder_d_ff, cfg.vocab_size, cfg.encoder_dropout,
            cfg.ffn_mode, dtype=dt, satellite=satellite), SD(
            cfg.cycle_num, cfg.decoder_d_model, cfg.decoder_num_heads,
            cfg.decoder_d_ff, cfg.vocab_size, cfg.decoder_dropout,
            cfg.ffn_mode, tie_embeddings=cfg.tie_embeddings, dtype=dt,
            satellite=satellite))


VARIANTS = ("transformer", "star", "star_multi")


def make_model(cfg: Config, variant: str = "transformer",
               attention: Callable = fused_attention,
               satellite: Callable = satellite_attention) -> _TransceiverBase:
    """The transceiver of `variant`: the vanilla one with `attention`, a
    star one with `satellite`."""
    if variant == "transformer":
        return Transceiver(cfg, attention)
    if variant == "star":
        return TransceiverStar(cfg, satellite)
    if variant == "star_multi":
        return TransceiverStarMulti(cfg, satellite)
    raise ValueError(f"variant {variant!r} is not ported yet; the port has "
                     f"{', '.join(VARIANTS)}")
