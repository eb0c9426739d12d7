"""Star-Transformer semantic codec (JAX package `models/star.py`): per
cycle, each satellite h_i attends over its five contexts {h_{i+1}, h_i,
h_{i-1}, e_i, s} (ReLU after), then the relay s attends over [s; h]
(encoder) or [s; h; h2] (decoder, h2 the masked target self-attention
output). After `cycle_num` cycles: residual + LayerNorm + FFN, with the
LayerNorm sharing of each reference class kept:

- `StarEncoderLayer` / `StarDecoderLayer` with `separate_relay=False` (the
  multi-layer `SEncoder` / `SDecoder`): the relay update reuses the
  satellite weights; the decoder reuses `layernorm1` for the target branch
  and the output residual.
- with `separate_relay=True` (the single-block `SE` / `SD`): separate relay
  weights; `SE`'s block reuses `layernorm1` for the FFN output
  (`share_ffn_ln`).

A LayerNorm or attention bank that a class never uses is not created, so
the modules hold exactly the parameters of the flax trees. The satellite
update projects Q/K/V once on h, K/V on e and on s, and hands the ring
unstacked to the satellite function the model was built with
(`ops/star_kernel.py`: K5 by default), which takes the neighbours circularly
over the padded length by index, as the JAX model's `jnp.roll` does.
The relay and the decoder's target self-attention are plain PyTorch, as
they are plain einsums in the JAX package. The encoder ignores its padding
mask, as in the JAX package, and a star decoder's output has the MEMORY's
length: its position i predicts token i.

With `fuse_qkv` (`Config.fuse_qkv`) the bank's projections that share an
input run as one matmul (`ops/layers.py:project_packed`), where the JAX
package's `_qkv` and `_kv` pack them: Q/K/V on h and on the decoder's
target, K/V on e, on s and on the relay's context.

Dropout sits at the JAX package's sites (the embedding; after the cycles
and after the FFN; in the decoder also after the target self-attention)
and draws its masks from the generator a forward is given.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from deepsc_gan_tpu_torch.models.transformer import (
    FeedForward,
    Gen,
    LayerNorm,
    TokenEmbed,
    VocabProjection,
)
from deepsc_gan_tpu_torch.ops.attention import NEG_INF
from deepsc_gan_tpu_torch.ops.layers import Dense, dropout, project_packed
from deepsc_gan_tpu_torch.ops.star_kernel import satellite_attention


class StarAttention(nn.Module):
    """The Q/K/V/out projection bank shared by the satellite, relay and
    full updates: bias-free `wq`, `wk`, `wv` and a biased `out`, laid out
    as `ops/attention.py:MultiHeadAttention`'s."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 satellite: Callable = satellite_attention,
                 fuse_qkv: bool = False):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.depth = d_model // num_heads
        self.satellite_op = satellite
        self.fuse_qkv = fuse_qkv
        self.wq = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.wk = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.wv = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.out = Dense(d_model, d_model, bias=True, dtype=dtype)

    def _kv(self, x):
        if self.fuse_qkv:
            return project_packed(x, (self.wk, self.wv))
        return self.wk(x), self.wv(x)

    def _qkv(self, x):
        if self.fuse_qkv:
            return project_packed(x, (self.wq, self.wk, self.wv))
        return self.wq(x), self.wk(x), self.wv(x)

    def satellite(self, h, e, s):
        """One ring update, before its ReLU: h, e (B, L, D), s (B, D) ->
        (B, L, D)."""
        out = self.satellite_op(*self._qkv(h), *self._kv(e), *self._kv(s),
                                self.num_heads)
        return self.out(out)

    def _attend(self, q, k, v, mask=None):
        """Per-head softmax(q k^T / sqrt(Dh) + mask * -1e9) v of projected
        q (B, Lq, D) and k, v (B, Lk, D): logits and softmax in f32, the
        weights cast to the activation dtype. -> (B, Lq, D)."""
        b, lq, d = q.shape

        def heads(x):
            return x.reshape(b, x.shape[1], self.num_heads,
                             self.depth).transpose(1, 2)

        logits = torch.matmul(heads(q), heads(k).transpose(-1, -2)).float() \
            / math.sqrt(self.depth)
        if mask is not None:
            logits = logits + mask.float() * NEG_INF
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.matmul(w, heads(v)).transpose(1, 2).reshape(b, lq, d)

    def relay(self, s, h, h2: Optional[torch.Tensor] = None):
        """The relay update, before its ReLU: s (B, D) attends over
        [s; h] (+ h2) -> (B, D)."""
        ctx = torch.cat([s[:, None], h] + ([h2] if h2 is not None else []),
                        dim=1)
        out = self._attend(self.wq(s[:, None]), *self._kv(ctx))
        return self.out(out)[:, 0]

    def full(self, q, k, v, mask=None):
        """Plain masked multi-head attention through the same weights (the
        decoder's target self-attention)."""
        if q is k and k is v:
            qkv = self._qkv(q)
        else:
            qkv = self.wq(q), self.wk(k), self.wv(v)
        return self.out(self._attend(*qkv, mask))


def _star_cycles(att_sat: StarAttention, att_relay: StarAttention, e,
                 h2: Optional[torch.Tensor], cycle_num: int):
    """`cycle_num` ring + relay cycles from h = e and s = the mean of e over
    every position (pads included). -> (h, s)."""
    h, s = e, e.mean(dim=1)
    for _ in range(cycle_num):
        h = torch.relu(att_sat.satellite(h, e, s))
        s = torch.relu(att_relay.relay(s, h, h2))
    return h, s


class StarEncoderLayer(nn.Module):
    def __init__(self, cycle_num, d_model, num_heads, dff, dropout_rate=0.0,
                 ffn_mode="mlp", separate_relay=False, share_ffn_ln=False,
                 dtype=torch.float32,
                 satellite: Callable = satellite_attention,
                 fuse_qkv: bool = False):
        super().__init__()
        self.cycle_num = cycle_num
        self.rate = dropout_rate
        self.separate_relay = separate_relay
        self.share_ffn_ln = share_ffn_ln
        self.att_satellite = StarAttention(d_model, num_heads, dtype,
                                           satellite, fuse_qkv)
        if separate_relay:
            self.att_relay = StarAttention(d_model, num_heads, dtype,
                                           satellite, fuse_qkv)
        self.sl2 = FeedForward(d_model, dff, ffn_mode, dtype)
        self.layernorm1 = LayerNorm(d_model, dtype)
        if not share_ffn_ln:
            self.layernorm2 = LayerNorm(d_model, dtype)

    def forward(self, e, gen: Gen = None):
        relay = self.att_relay if self.separate_relay else self.att_satellite
        h, s = _star_cycles(self.att_satellite, relay, e, None,
                            self.cycle_num)
        out1 = self.layernorm1(e + dropout(h, self.rate, gen))
        ffn = dropout(self.sl2(out1), self.rate, gen)
        ln_out = self.layernorm1 if self.share_ffn_ln else self.layernorm2
        return ln_out(out1 + ffn), s


class StarDecoderLayer(nn.Module):
    """The target stream enters only through the relay context
    [s; h; h2]; the output has the memory's length."""

    def __init__(self, cycle_num, d_model, num_heads, dff, dropout_rate=0.0,
                 ffn_mode="mlp", separate_relay=False, dtype=torch.float32,
                 satellite: Callable = satellite_attention,
                 fuse_qkv: bool = False):
        super().__init__()
        self.cycle_num = cycle_num
        self.rate = dropout_rate
        self.separate_relay = separate_relay
        self.multi_tar = StarAttention(d_model, num_heads, dtype, satellite,
                                       fuse_qkv)
        self.att_satellite = StarAttention(d_model, num_heads, dtype,
                                           satellite, fuse_qkv)
        if separate_relay:
            self.att_relay = StarAttention(d_model, num_heads, dtype,
                                           satellite, fuse_qkv)
        self.sl2 = FeedForward(d_model, dff, ffn_mode, dtype)
        self.layernorm1 = LayerNorm(d_model, dtype)
        self.layernorm2 = LayerNorm(d_model, dtype)
        if separate_relay:
            self.layernorm3 = LayerNorm(d_model, dtype)

    def forward(self, tar, e, look_ahead_mask, gen: Gen = None):
        attn1 = dropout(self.multi_tar.full(tar, tar, tar, look_ahead_mask),
                        self.rate, gen)
        h2 = self.layernorm1(tar + attn1)
        relay = self.att_relay if self.separate_relay else self.att_satellite
        h, s = _star_cycles(self.att_satellite, relay, e, h2, self.cycle_num)
        attn = dropout(h, self.rate, gen)
        if self.separate_relay:
            ln_res, ln_out = self.layernorm2, self.layernorm3
        else:
            ln_res, ln_out = self.layernorm1, self.layernorm2
        out1 = ln_res(e + attn)
        ffn = dropout(self.sl2(out1), self.rate, gen)
        return ln_out(out1 + ffn), s


class SEncoder(nn.Module):
    """Multi-layer star encoder (`layer{i}` of StarEncoderLayer)."""

    def __init__(self, cycle_num, num_layers, num_heads, d_model, dff,
                 vocab_size, dropout_rate=0.0, ffn_mode="mlp",
                 max_position=512, dtype=torch.float32,
                 satellite: Callable = satellite_attention,
                 fuse_qkv: bool = False):
        super().__init__()
        self.embed = TokenEmbed(vocab_size, d_model, max_position, dtype,
                                dropout_rate)
        self.layers = nn.ModuleList(
            StarEncoderLayer(cycle_num, d_model, num_heads, dff, dropout_rate,
                             ffn_mode, dtype=dtype, satellite=satellite,
                             fuse_qkv=fuse_qkv)
            for _ in range(num_layers))

    def forward(self, tokens, mask=None, gen: Gen = None):
        x = self.embed(tokens, gen)
        for layer in self.layers:
            x, _ = layer(x, gen)
        return x


class SDecoder(VocabProjection):
    """Multi-layer star decoder and the vocab projection."""

    def __init__(self, cycle_num, num_layers, d_model, num_heads, dff,
                 vocab_size, dropout_rate=0.0, ffn_mode="mlp",
                 max_position=512, tie_embeddings=False, dtype=torch.float32,
                 satellite: Callable = satellite_attention,
                 fuse_qkv: bool = False):
        super().__init__()
        self.embed = TokenEmbed(vocab_size, d_model, max_position, dtype,
                                dropout_rate)
        self.layers = nn.ModuleList(
            StarDecoderLayer(cycle_num, d_model, num_heads, dff, dropout_rate,
                             ffn_mode, dtype=dtype, satellite=satellite,
                             fuse_qkv=fuse_qkv)
            for _ in range(num_layers))
        self._vocab_head(d_model, vocab_size, tie_embeddings)

    def forward(self, tokens, enc_output, look_ahead_mask, padding_mask=None,
                apply_final: bool = True, gen: Gen = None):
        tar = self.embed(tokens, gen)
        x = enc_output
        for layer in self.layers:
            x, _ = layer(tar, x, look_ahead_mask, gen)
        return self.final_projection(x) if apply_final else x


class SE(nn.Module):
    """Single-block star encoder (`block`, separate relay weights, one
    LayerNorm for both residuals)."""

    def __init__(self, cycle_num, num_heads, d_model, dff, vocab_size,
                 dropout_rate=0.0, ffn_mode="mlp", max_position=512,
                 dtype=torch.float32,
                 satellite: Callable = satellite_attention,
                 fuse_qkv: bool = False):
        super().__init__()
        self.embed = TokenEmbed(vocab_size, d_model, max_position, dtype,
                                dropout_rate)
        self.block = StarEncoderLayer(
            cycle_num, d_model, num_heads, dff, dropout_rate, ffn_mode,
            separate_relay=True, share_ffn_ln=True, dtype=dtype,
            satellite=satellite, fuse_qkv=fuse_qkv)

    def forward(self, tokens, mask=None, gen: Gen = None):
        x, _ = self.block(self.embed(tokens, gen), gen)
        return x


class SD(VocabProjection):
    """Single-block star decoder (`block`, separate relay weights) and the
    vocab projection."""

    def __init__(self, cycle_num, d_model, num_heads, dff, vocab_size,
                 dropout_rate=0.0, ffn_mode="mlp", max_position=512,
                 tie_embeddings=False, dtype=torch.float32,
                 satellite: Callable = satellite_attention,
                 fuse_qkv: bool = False):
        super().__init__()
        self.embed = TokenEmbed(vocab_size, d_model, max_position, dtype,
                                dropout_rate)
        self.block = StarDecoderLayer(
            cycle_num, d_model, num_heads, dff, dropout_rate, ffn_mode,
            separate_relay=True, dtype=dtype, satellite=satellite,
            fuse_qkv=fuse_qkv)
        self._vocab_head(d_model, vocab_size, tie_embeddings)

    def forward(self, tokens, enc_output, look_ahead_mask, padding_mask=None,
                apply_final: bool = True, gen: Gen = None):
        x, _ = self.block(self.embed(tokens, gen), enc_output,
                          look_ahead_mask, gen)
        return self.final_projection(x) if apply_final else x
