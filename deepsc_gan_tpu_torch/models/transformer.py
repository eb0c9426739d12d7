"""Vanilla Transformer semantic encoder/decoder (JAX package
`models/transformer.py`): post-LN layers with LayerNorm eps 1e-6, the
embedding scaled by sqrt(d_model) plus the sinusoidal table, and a vocab
projection in f32, tied to the decoder embedding or a separate Dense.

Every parameter is f32; Dense layers compute in the activation dtype
(`ops/layers.py:Dense`), LayerNorm statistics and affine in f32, as flax
computes with them. Dropout sits at the JAX package's seven sites (after
the embedding's positional table; after the attention and the FFN of an
encoder layer; after the self-attention, the cross-attention and the FFN
of a decoder layer) and draws its masks from the generator a forward is
given; without one every layer is deterministic.

With `remat` (`Config.remat`, the JAX package's `_maybe_remat`) each
encoder and decoder layer is recomputed in the backward instead of keeping
its intermediates (`torch.utils.checkpoint`, non-reentrant). The
recompute must apply the masks of the first forward and leave the
generator where the first forward left it, but
`torch.utils.checkpoint` restores only the default generators' states,
and an explicit generator's state cannot be read or set inside a CUDA
graph capture. So a recomputed layer draws through a `MaskTape`
(`ops/layers.py`): its masks are drawn from the generator in the first
forward, in the same order, and kept (a byte an element); the recompute
reads them back. Values, gradients and the generator's state are those of
the step without remat; each K1 of a recomputed layer launches twice.
`fuse_qkv` packs the attentions' projections (`ops/attention.py`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from deepsc_gan_tpu_torch.ops.attention import MultiHeadAttention
from deepsc_gan_tpu_torch.ops.attention_kernel import fused_attention
from deepsc_gan_tpu_torch.ops.layers import Dense, MaskTape, dropout
from deepsc_gan_tpu_torch.ops.positional import positional_encoding

Gen = Optional[torch.Generator]

LN_EPS = 1e-6


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm with an activation dtype: statistics and affine in
    f32, the result cast to the activation dtype."""

    def __init__(self, d_model: int, dtype=torch.float32):
        super().__init__(d_model, eps=LN_EPS)
        self.act_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.act_dtype)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, dff: int, mode: str = "mlp",
                 dtype=torch.float32):
        super().__init__()
        if mode not in ("mlp", "identity"):
            raise ValueError(f"ffn mode {mode!r}")
        self.mode = mode
        if mode == "mlp":
            self.fc1 = Dense(d_model, dff, dtype=dtype)
            self.fc2 = Dense(dff, d_model, dtype=dtype)

    def forward(self, x):
        if self.mode == "identity":
            return x
        return self.fc2(torch.relu(self.fc1(x)))


def remat_layer(layer: nn.Module, *args, gen: Gen = None):
    """`layer(*args, gen)` recomputed in the backward, its dropout masks
    drawn once and kept (see the module docstring); without autograd, the
    plain call."""
    if not torch.is_grad_enabled():
        return layer(*args, gen)
    tape = None if gen is None else MaskTape(gen)

    def run(*a):
        if tape is not None and tape.recorded:
            tape.rewind()
        return layer(*a, tape)

    out = torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)
    if tape is not None:
        tape.recorded = True
    return out


class EncoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, dff, dropout_rate=0.0,
                 ffn_mode="mlp", dtype=torch.float32,
                 attention: Callable = fused_attention,
                 fuse_qkv: bool = False):
        super().__init__()
        self.rate = dropout_rate
        self.mha = MultiHeadAttention(d_model, num_heads, dtype, attention,
                                      fuse_qkv)
        self.ffn = FeedForward(d_model, dff, ffn_mode, dtype)
        self.ln1 = LayerNorm(d_model, dtype)
        self.ln2 = LayerNorm(d_model, dtype)

    def forward(self, x, mask, gen: Gen = None):
        attn = dropout(self.mha(x, x, x, mask), self.rate, gen)
        out1 = self.ln1(x + attn)
        ffn = dropout(self.ffn(out1), self.rate, gen)
        return self.ln2(out1 + ffn)


class DecoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, dff, dropout_rate=0.0,
                 ffn_mode="mlp", dtype=torch.float32,
                 attention: Callable = fused_attention,
                 fuse_qkv: bool = False):
        super().__init__()
        self.rate = dropout_rate
        self.self_mha = MultiHeadAttention(d_model, num_heads, dtype,
                                           attention, fuse_qkv)
        self.cross_mha = MultiHeadAttention(d_model, num_heads, dtype,
                                            attention, fuse_qkv)
        self.ffn = FeedForward(d_model, dff, ffn_mode, dtype)
        self.ln1 = LayerNorm(d_model, dtype)
        self.ln2 = LayerNorm(d_model, dtype)
        self.ln3 = LayerNorm(d_model, dtype)

    def forward(self, x, enc_output, look_ahead_mask, padding_mask,
                gen: Gen = None):
        attn1 = dropout(self.self_mha(x, x, x, look_ahead_mask), self.rate,
                        gen)
        out1 = self.ln1(x + attn1)
        attn2 = dropout(self.cross_mha(out1, enc_output, enc_output,
                                       padding_mask), self.rate, gen)
        out2 = self.ln2(attn2 + out1)
        ffn = dropout(self.ffn(out2), self.rate, gen)
        return self.ln3(ffn + out2)


class TokenEmbed(nn.Module):
    """Embedding * sqrt(d_model) + positional table + dropout, in the
    activation dtype (the table itself stays f32: a tied decoder projects
    with it)."""

    def __init__(self, vocab_size, d_model, max_position=512,
                 dtype=torch.float32, dropout_rate=0.0):
        super().__init__()
        self.rate = dropout_rate
        self.embedding = nn.Embedding(vocab_size, d_model)
        self.dtype = dtype
        # sqrt computed in the activation dtype, as jnp.sqrt(asarray(d, dt))
        self.register_buffer(
            "sqrt_d", torch.tensor(float(d_model), dtype=dtype).sqrt(),
            persistent=False)
        self.register_buffer(
            "pe", positional_encoding(max_position, d_model, dtype),
            persistent=False)

    def forward(self, tokens, gen: Gen = None):
        x = self.embedding(tokens).to(self.dtype) * self.sqrt_d
        return dropout(x + self.pe[:, :tokens.shape[1], :], self.rate, gen)


class Encoder(nn.Module):
    def __init__(self, num_layers, num_heads, d_model, dff, vocab_size,
                 dropout_rate=0.0, ffn_mode="mlp", max_position=512,
                 dtype=torch.float32, attention: Callable = fused_attention,
                 remat: bool = False, fuse_qkv: bool = False):
        super().__init__()
        self.remat = remat
        self.embed = TokenEmbed(vocab_size, d_model, max_position, dtype,
                                dropout_rate)
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, num_heads, dff, dropout_rate, ffn_mode,
                         dtype, attention, fuse_qkv)
            for _ in range(num_layers))

    def forward(self, tokens, mask, gen: Gen = None):
        x = self.embed(tokens, gen)
        for layer in self.layers:
            x = (remat_layer(layer, x, mask, gen=gen) if self.remat
                 else layer(x, mask, gen))
        return x


class VocabProjection(nn.Module):
    """The vocab projection of a decoder, in f32: tied to the decoder's
    embedding table `embed` with a `final_bias`, or a separate Dense
    `final_layer` (the names the flax trees use). Shared by the vanilla and
    the star decoders."""

    def _vocab_head(self, d_model: int, vocab_size: int,
                    tie_embeddings: bool) -> None:
        self.tie_embeddings = tie_embeddings
        if tie_embeddings:
            self.final_bias = nn.Parameter(torch.zeros(vocab_size))
        else:
            self.final_layer = nn.Linear(d_model, vocab_size)

    def final_projection(self, x):
        """Vocab logits in f32."""
        if self.tie_embeddings:
            return x.float() @ self.embed.embedding.weight.float().T \
                + self.final_bias.float()
        return self.final_layer(x.float())


class Decoder(VocabProjection):
    """Embedding prologue + N decoder layers; `final_projection` is
    separate so greedy decoding projects only the position it reads."""

    def __init__(self, num_layers, d_model, num_heads, dff, vocab_size,
                 dropout_rate=0.0, ffn_mode="mlp", max_position=512,
                 tie_embeddings=False, dtype=torch.float32,
                 attention: Callable = fused_attention,
                 remat: bool = False, fuse_qkv: bool = False):
        super().__init__()
        self.remat = remat
        self.embed = TokenEmbed(vocab_size, d_model, max_position, dtype,
                                dropout_rate)
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, num_heads, dff, dropout_rate, ffn_mode,
                         dtype, attention, fuse_qkv)
            for _ in range(num_layers))
        self._vocab_head(d_model, vocab_size, tie_embeddings)

    def forward(self, tokens, enc_output, look_ahead_mask, padding_mask,
                apply_final: bool = True, gen: Gen = None):
        x = self.embed(tokens, gen)
        for layer in self.layers:
            args = (x, enc_output, look_ahead_mask, padding_mask)
            x = (remat_layer(layer, *args, gen=gen) if self.remat
                 else layer(*args, gen))
        return self.final_projection(x) if apply_final else x
