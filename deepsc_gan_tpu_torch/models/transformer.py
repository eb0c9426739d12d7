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
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepsc_gan_tpu_torch.ops.attention import MultiHeadAttention
from deepsc_gan_tpu_torch.ops.attention_kernel import fused_attention
from deepsc_gan_tpu_torch.ops.layers import Dense, dropout
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


class EncoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, dff, dropout_rate=0.0,
                 ffn_mode="mlp", dtype=torch.float32,
                 attention: Callable = fused_attention):
        super().__init__()
        self.rate = dropout_rate
        self.mha = MultiHeadAttention(d_model, num_heads, dtype, attention)
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
                 attention: Callable = fused_attention):
        super().__init__()
        self.rate = dropout_rate
        self.self_mha = MultiHeadAttention(d_model, num_heads, dtype,
                                           attention)
        self.cross_mha = MultiHeadAttention(d_model, num_heads, dtype,
                                            attention)
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
                 dtype=torch.float32, attention: Callable = fused_attention):
        super().__init__()
        self.embed = TokenEmbed(vocab_size, d_model, max_position, dtype,
                                dropout_rate)
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, num_heads, dff, dropout_rate, ffn_mode,
                         dtype, attention)
            for _ in range(num_layers))

    def forward(self, tokens, mask, gen: Gen = None):
        x = self.embed(tokens, gen)
        for layer in self.layers:
            x = layer(x, mask, gen)
        return x


class Decoder(nn.Module):
    """Embedding prologue + N decoder layers; `final_projection` is
    separate so greedy decoding projects only the position it reads."""

    def __init__(self, num_layers, d_model, num_heads, dff, vocab_size,
                 dropout_rate=0.0, ffn_mode="mlp", max_position=512,
                 tie_embeddings=False, dtype=torch.float32,
                 attention: Callable = fused_attention):
        super().__init__()
        self.tie_embeddings = tie_embeddings
        self.embed = TokenEmbed(vocab_size, d_model, max_position, dtype,
                                dropout_rate)
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, num_heads, dff, dropout_rate, ffn_mode,
                         dtype, attention)
            for _ in range(num_layers))
        if tie_embeddings:
            self.final_bias = nn.Parameter(torch.zeros(vocab_size))
        else:
            self.final_layer = nn.Linear(d_model, vocab_size)

    def forward(self, tokens, enc_output, look_ahead_mask, padding_mask,
                apply_final: bool = True, gen: Gen = None):
        x = self.embed(tokens, gen)
        for layer in self.layers:
            x = layer(x, enc_output, look_ahead_mask, padding_mask, gen)
        return self.final_projection(x) if apply_final else x

    def final_projection(self, x):
        """Vocab logits in f32."""
        if self.tie_embeddings:
            return x.float() @ self.embed.embedding.weight.float().T \
                + self.final_bias.float()
        return self.final_layer(x.float())
