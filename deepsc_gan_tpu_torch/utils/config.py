"""Configuration of the port: the fields of the JAX package's `Config`
that the serving path and the plain training path read, with the same
names and defaults.

A frozen dataclass like the JAX package's (`deepsc_gan_tpu/utils/config.py`),
kept as the port's own copy so the port imports nothing of that package.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class Config:
    # --- data paths
    train_save_path: str = "data/txt/train_data.pkl"
    test_save_path: str = "data/txt/test_data.pkl"
    vocab_path: str = "data/txt/vocab.json"
    log_save_path: str = "log"
    checkpoint_path: str = "checkpoint"

    # --- batching, training and decoding
    bs: int = 64
    lr: float = 5e-4
    epochs: int = 60
    max_length: int = 30        # decode steps
    seq_len: int = 32           # padded sentence length
    channel: str = "AWGN"

    # --- model
    vocab_size: int = 22234
    encoder_num_layer: int = 4
    encoder_d_model: int = 128
    encoder_d_ff: int = 512
    encoder_num_heads: int = 8
    encoder_dropout: float = 0.1
    decoder_num_layer: int = 4
    decoder_d_model: int = 128
    decoder_d_ff: int = 512
    decoder_num_heads: int = 8
    decoder_dropout: float = 0.1

    # --- channel codec
    channel_hidden: int = 256
    channel_dim: int = 16
    channel_dec_hidden: int = 512

    # --- training SNR: the fixed train_snr dB, or with train_snr_random a
    #     per-step draw U(lo, hi) dB (with probability train_snr_mix)
    train_snr: int = 3
    train_snr_random: bool = False
    train_snr_lo: float = 0.0
    train_snr_hi: float = 18.0
    train_snr_mix: float = 1.0

    # --- quirk Q1: "mlp" | "identity" feed-forward sublayer
    ffn_mode: str = "mlp"
    # --- quirk Q2: also mask ids 4 and 5 in the loss (the reference means
    #     to, but a bug leaves it pad-only)
    mask_extra_tokens: bool = False

    # --- special token ids
    pad_idx: int = 0
    start_idx: int = 1
    end_idx: int = 2
    unk_idx: int = 3

    tie_embeddings: bool = False
    label_smoothing: float = 0.0
    # exponential moving average of the params (0 = off); evaluation and
    # the saved params use the shadow when on
    ema_decay: float = 0.0

    # --- schedule: "constant" | "noam" | "cosine" (ops/schedule.py)
    schedule: str = "constant"
    warmup_steps: int = 4000
    decay_steps: int = 40000

    # --- compute
    dtype: str = "bfloat16"      # activations
    param_dtype: str = "float32"
    # vocab projection + CE through the online-softmax kernels (the
    # logits are never materialized); False materializes them
    fused_ce: bool = True

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """Register every Config field as a --flag (dashes for underscores)."""
    for f in dataclasses.fields(Config):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=f.default)
        else:
            parser.add_argument(name, type=type(f.default), default=f.default)


def config_from_args(args: argparse.Namespace) -> Config:
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in names})


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
