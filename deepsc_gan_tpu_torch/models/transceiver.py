"""The DeepSC transceivers (JAX package `models/transceiver.py:44-300`):
the vanilla Transformer codec (`Transceiver`), the single-block star codec
(`TransceiverStar`, SE/SD), the multi-layer one (`TransceiverStarMulti`,
SEncoder/SDecoder), and the GAN transceivers around the vanilla and the
single-block star codec (`TransceiverGAN`, `TransceiverGANStar`: the codec
plus a perturbation `generator`, and a forward that runs the channel twice),
each with the dense channel codec, as stages: `encode`
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
from deepsc_gan_tpu_torch.models.gan import Generator
from deepsc_gan_tpu_torch.models.star import SD, SE, SDecoder, SEncoder
from deepsc_gan_tpu_torch.models.transformer import Decoder, Encoder, Gen
from deepsc_gan_tpu_torch.ops.attention_kernel import fused_attention
from deepsc_gan_tpu_torch.ops.star_kernel import satellite_attention
from deepsc_gan_tpu_torch.utils.config import (
    VARIANTS,
    Config,
    is_star,
    torch_dtype,
)


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
    function of its layers; cfg.remat recomputes each layer in the
    backward and cfg.fuse_qkv packs the attentions' projections."""

    def __init__(self, cfg: Config, attention: Callable = fused_attention):
        dt = torch_dtype(cfg.dtype)
        super().__init__(cfg, Encoder(
            cfg.encoder_num_layer, cfg.encoder_num_heads, cfg.encoder_d_model,
            cfg.encoder_d_ff, cfg.vocab_size, cfg.encoder_dropout,
            cfg.ffn_mode, dtype=dt, attention=attention, remat=cfg.remat,
            fuse_qkv=cfg.fuse_qkv), Decoder(
            cfg.decoder_num_layer, cfg.decoder_d_model, cfg.decoder_num_heads,
            cfg.decoder_d_ff, cfg.vocab_size, cfg.decoder_dropout,
            cfg.ffn_mode, tie_embeddings=cfg.tie_embeddings, dtype=dt,
            attention=attention, remat=cfg.remat, fuse_qkv=cfg.fuse_qkv))


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
            satellite=satellite, fuse_qkv=cfg.fuse_qkv), SDecoder(
            cfg.cycle_num, cfg.decoder_num_layer, cfg.decoder_d_model,
            cfg.decoder_num_heads, cfg.decoder_d_ff, cfg.vocab_size,
            cfg.decoder_dropout, cfg.ffn_mode,
            tie_embeddings=cfg.tie_embeddings, dtype=dt,
            satellite=satellite, fuse_qkv=cfg.fuse_qkv))


class TransceiverStar(_TransceiverBase):
    """The single-block star transceiver (reference `Transeiver_Star`, the
    variant of `results/star_best_params.pkl`)."""

    def __init__(self, cfg: Config,
                 satellite: Callable = satellite_attention):
        dt = torch_dtype(cfg.dtype)
        super().__init__(cfg, SE(
            cfg.cycle_num, cfg.encoder_num_heads, cfg.encoder_d_model,
            cfg.encoder_d_ff, cfg.vocab_size, cfg.encoder_dropout,
            cfg.ffn_mode, dtype=dt, satellite=satellite,
            fuse_qkv=cfg.fuse_qkv), SD(
            cfg.cycle_num, cfg.decoder_d_model, cfg.decoder_num_heads,
            cfg.decoder_d_ff, cfg.vocab_size, cfg.decoder_dropout,
            cfg.ffn_mode, tie_embeddings=cfg.tie_embeddings, dtype=dt,
            satellite=satellite, fuse_qkv=cfg.fuse_qkv))


class _GAN:
    """The GAN transceivers' part (JAX `TransceiverGAN`): a perturbation
    `generator` beside the codec, and a forward that transmits tx twice."""

    def __init__(self, cfg: Config, *args):
        super().__init__(cfg, *args)
        self.generator = Generator(cfg.channel_dim, cfg.channel_hidden,
                                   cfg.channel_dim, torch_dtype(cfg.dtype))

    def generate_perturbation(self, tx):
        return self.generator(tx)

    def forward(self, inp, tar_inp, noise_p, noise_r, n_std,
                p: Optional[torch.Tensor] = None, pnr_db: float = 0.0,
                enc_padding_mask=None, combined_mask=None,
                dec_padding_mask=None, gen: Gen = None,
                traingan: bool = False, fade_p=None, fade_r=None,
                apply_final: bool = True):
        """-> (pred_p, pred_r, tx, y_r): tx through the channel twice, with
        the perturbation (`p`, or the generator's G(tx) when `traingan`) at
        `pnr_db` on the draws `noise_p`/`fade_p`, and clean on
        `noise_r`/`fade_r`; both receptions decoded (logits in f32, or with
        `apply_final` False the decoder's hidden states, as
        `decode_loss_ready`). Dropout masks come from `gen` in the order
        encoder, branch p, branch r."""
        tx = self.encode(inp, enc_padding_mask, gen)
        if traingan:
            p = self.generator(tx)
        y_p = self.transmit(tx, noise_p, n_std, p, pnr_db, fade=fade_p)
        y_r = self.transmit(tx, noise_r, n_std, None, pnr_db, fade=fade_r)
        pred_p = self.decode(tar_inp, y_p, combined_mask, dec_padding_mask,
                             gen, apply_final)
        pred_r = self.decode(tar_inp, y_r, combined_mask, dec_padding_mask,
                             gen, apply_final)
        return pred_p, pred_r, tx, y_r


class TransceiverGAN(_GAN, Transceiver):
    """The vanilla GAN transceiver (reference `Transeiver_GAN`)."""


class TransceiverGANStar(_GAN, TransceiverStar):
    """The GAN transceiver around the single-block star codec (the JAX
    package's extension); its decoder outputs at the memory's length, so
    it trains on the un-shifted target."""


_CLASSES = {"transformer": Transceiver, "star": TransceiverStar,
            "star_multi": TransceiverStarMulti, "gan": TransceiverGAN,
            "gan_star": TransceiverGANStar}


def make_model(cfg: Config, variant: str = "transformer",
               attention: Callable = fused_attention,
               satellite: Callable = satellite_attention) -> _TransceiverBase:
    """The transceiver of `variant`: a vanilla codec with `attention`, a
    star one with `satellite`."""
    if variant not in _CLASSES:
        raise ValueError(f"unknown variant {variant!r}; the port has "
                         f"{', '.join(VARIANTS)}")
    return _CLASSES[variant](cfg, satellite if is_star(variant)
                             else attention)
