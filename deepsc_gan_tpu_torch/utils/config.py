"""Configuration of the port: the fields of the JAX package's `Config`
with the same names and defaults, and the padded length of each model
variant.

Of the parallel fields, `dp` is the data-parallel size of `cli train`
(`parallel/sharding.py`, over a `torch.distributed` group); `tp` and `pp`
above 1 stop the CLI (ROADMAP §A.2.2 and §A.2.3 bring them), and
`pp_microbatches` is carried for them.

Four fields are accepted and recorded but change nothing in the port:
`rng_impl` (its draws come from a `torch.Generator`), `ce_chunk` (the CE
kernels tile the vocab themselves), `shuffle_size` (unused in the JAX
package too) and `input_data_dir` (the port's `preprocess` command reads
its own `--input-data-dir` flag, `data/preprocess.py:add_args`, as the JAX
one does). `train_with_mine` is carried as the JAX package carries it
(`--train-mode mine` selects MINE training).

A frozen dataclass like the JAX package's (`deepsc_gan_tpu/utils/config.py`),
kept as the port's own copy so the port imports nothing of that package.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class Config:
    # --- data paths (`input_data_dir`: no effect in the port)
    input_data_dir: str = "data/txt/en"
    train_save_path: str = "data/txt/train_data.pkl"
    test_save_path: str = "data/txt/test_data.pkl"
    vocab_path: str = "data/txt/vocab.json"
    log_save_path: str = "log"
    checkpoint_path: str = "checkpoint"

    # --- batching, training and decoding
    bs: int = 64
    shuffle_size: int = 22234   # no effect (unused in the JAX package too)
    lr: float = 5e-4
    epochs: int = 60
    # MINE (train/mine_steps.py): the transceiver's update takes
    # ce - mine_lambda * MI; `train_with_mine` is carried, nothing reads it
    train_with_mine: bool = False
    mine_lambda: float = 0.0009
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
    # Star codec: ring + relay cycles per layer (`cycle_layers` is carried
    # as the JAX package carries it; nothing reads it)
    cycle_num: int = 8
    cycle_layers: int = 8

    # --- channel codec
    channel_hidden: int = 256
    channel_dim: int = 16
    channel_dec_hidden: int = 512

    # --- training SNR: the fixed train_snr dB, or with train_snr_random a
    #     per-step draw U(lo, hi) dB (with probability train_snr_mix)
    train_snr: int = 3
    # carried as the JAX package carries it; nothing reads it
    test_snr: int = 6
    train_snr_random: bool = False
    train_snr_lo: float = 0.0
    train_snr_hi: float = 18.0
    train_snr_mix: float = 1.0

    # --- quirk Q1: "mlp" | "identity" feed-forward sublayer
    ffn_mode: str = "mlp"
    # --- quirk Q2: also mask ids 4 and 5 in the loss (the reference means
    #     to, but a bug leaves it pad-only)
    mask_extra_tokens: bool = False
    # --- quirk Q3: None returns the un-equalized fading output, as the
    #     reference does; "LS" | "MMSE" return the equalized estimate
    equalizer: Optional[str] = None
    # one fade per batch row instead of one per call (models/channel.py)
    fading_per_sample: bool = False

    # --- special token ids
    pad_idx: int = 0
    start_idx: int = 1
    end_idx: int = 2
    unk_idx: int = 3

    tie_embeddings: bool = False
    label_smoothing: float = 0.0
    # training-data augmentation (data/augment.py): per-sentence
    # probabilities of a synthetic full-vocab sentence, a concatenation of
    # two and a word-span crop (0 = the plain shuffled set)
    aug_crop: float = 0.0
    aug_concat: float = 0.0
    aug_synth: float = 0.0
    # exponential moving average of the params (0 = off); evaluation and
    # the saved params use the shadow when on
    ema_decay: float = 0.0

    # --- GAN 3-phase training (train/gan_steps.py): d_loss = lambda CE_r +
    #     (1 - lambda) CE_p; the perturbed branch at gan_pnr_db; g_loss =
    #     g_loss_ceiling - CE_p
    gan_lambda: float = 0.5
    gan_pnr_db: float = 40.0
    g_loss_ceiling: float = 10.0

    # --- schedule: "constant" | "noam" | "cosine" (ops/schedule.py)
    schedule: str = "constant"
    warmup_steps: int = 4000
    decay_steps: int = 40000

    # --- compute
    dtype: str = "bfloat16"      # activations
    param_dtype: str = "float32"
    # no effect: the port's draws come from a torch.Generator
    rng_impl: str = "threefry"
    # recompute each vanilla encoder and decoder layer in the backward
    # (models/transformer.py:remat_layer), its dropout masks kept
    remat: bool = False
    # vocab projection + CE through the online-softmax kernels (the
    # logits are never materialized); False materializes them
    fused_ce: bool = True
    ce_chunk: int = 2048        # no effect: K3/K4 tile the vocab themselves
    # Q/K/V projections that share an input as one matmul (the vanilla
    # attention and the star banks); the parameters are unchanged
    fuse_qkv: bool = False

    # --- parallelism: the data-parallel size of training; tensor- and
    #     pipeline-parallel sizes and GPipe's microbatches (not in the port
    #     yet: above 1 the CLI stops)
    dp: int = 1
    tp: int = 1
    pp: int = 1
    pp_microbatches: int = 4

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


VARIANTS = ("transformer", "star", "star_multi", "gan", "gan_star")
STAR_VARIANTS = ("star", "star_multi", "gan_star")
GAN_VARIANTS = ("gan", "gan_star")


def is_star(variant: str) -> bool:
    """Whether `variant` has a star codec (the JAX CLI's `STAR_VARIANTS`):
    its seq_len, one-shot decoding and un-shifted target."""
    return variant in STAR_VARIANTS


def is_gan(variant: str) -> bool:
    """Whether `variant` is a GAN transceiver (a generator beside its
    codec)."""
    return variant in GAN_VARIANTS


def default_seq_len(variant: str) -> int:
    """Padded sentence length of a model variant (JAX package
    `utils/config.py:174`): 31 for the star codecs (31 satellites and the
    relay), 32 for the others."""
    return 31 if "star" in variant else 32


_NO_EFFECT = "accepted and recorded; no effect in the port"
HELP = {
    "input_data_dir": _NO_EFFECT,
    "shuffle_size": _NO_EFFECT + " (unused in the JAX package too)",
    "rng_impl": _NO_EFFECT + ": its draws come from a torch.Generator",
    "ce_chunk": _NO_EFFECT + ": the CE kernels tile the vocab themselves",
    "train_with_mine": "carried as the JAX package carries it; "
                       "--train-mode mine selects MINE training",
    "mine_lambda": "MINE mode: the transceiver's loss is ce - "
                   "mine_lambda * MI",
    "aug_crop": "P(a random contiguous word-span crop of a sentence)",
    "aug_concat": "P(two sentences' words joined, truncated)",
    "aug_synth": "P(a synthetic sentence over the full vocab)",
    "remat": "recompute each vanilla encoder and decoder layer in the "
             "backward (dropout masks kept): less activation memory for "
             "about a fifth more time a step (PERF.md)",
    "dp": "data-parallel size of train: one process a rank under a "
          "launcher (torchrun) with --distributed; bs divisible by it",
    "tp": "tensor-parallel size; above 1 not in the port yet (ROADMAP "
          "§A.2.2)",
    "pp": "pipeline-parallel stages; above 1 not in the port yet (ROADMAP "
          "§A.2.3)",
    "pp_microbatches": "GPipe microbatches a step (carried for --pp)",
    "fuse_qkv": "Q/K/V projections sharing an input as one matmul; kept "
                "for the JAX CLI's flags, no reliable gain on the H100 "
                "(PERF.md)",
}


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """Register every Config field as a --flag (dashes for underscores).
    `--seq-len` defaults to None: a command that knows its variant resolves
    it with `default_seq_len`, else `config_from_args` takes the dataclass
    default."""
    for f in dataclasses.fields(Config):
        name = "--" + f.name.replace("_", "-")
        doc = HELP.get(f.name)
        if f.name == "seq_len":
            parser.add_argument(name, type=int, default=None)
        elif isinstance(f.default, bool):
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=f.default, help=doc)
        else:
            typ = str if f.default is None else type(f.default)
            parser.add_argument(name, type=typ, default=f.default, help=doc)


def config_from_args(args: argparse.Namespace) -> Config:
    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(args).items() if k in names}
    if kw.get("seq_len") is None:
        kw.pop("seq_len", None)
    return Config(**kw)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
