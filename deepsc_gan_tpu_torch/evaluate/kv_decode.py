"""KV-cached greedy decoding of the vanilla transceiver (JAX package
`evaluate/kv_decode.py`).

The full-prefix decoder (`evaluate/greedy.py`) runs the whole decoder over
the (N, max_length+1) buffer at every step. Here each step computes one
position through the stack: per layer the self-attention K and V of that
position are written into a buffer of max_length+1 positions, the
cross-attention K and V of the memory are projected once, and the query
attends over the buffer with the future and the <PAD> positions blocked,
the rows masked attention over the full buffer computes. So at f32 the ids
equal the full-prefix decoder's; in bf16 a reduction order may differ in the
last bit and flip an argmax tie.

The helpers below are plain PyTorch over the port's modules (the decode
step's attention is einsum code outside any kernel in the JAX package too);
the encoder prefill goes through the model, so through kernel K1. Buffers
are (N, H, max_length+1, Dh), PyTorch's batched-matmul layout, where the JAX
package keeps (N, max_length+1, H, Dh); the values are the same.
`evaluate/beam.py` shares `_layer_step` and the helpers.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from deepsc_gan_tpu_torch.evaluate.greedy import noise_sweep, single_level
from deepsc_gan_tpu_torch.ops.positional import positional_encoding
from deepsc_gan_tpu_torch.train.steps import _final_wb
from deepsc_gan_tpu_torch.utils.config import Config, torch_dtype

NEG = -1e9


def _ln(ln, x):
    """flax LayerNorm semantics: statistics and affine in f32 -> f32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


def _qkv(dense, x, heads: int):
    """x (N, D) -> (N, H, Dh) through a bias-free projection."""
    return dense(x).unflatten(-1, (heads, -1))


def _kv_memory(mha, mem):
    """mem (N, Lm, D) -> K, V (N, H, Lm, Dh), projected once: the layout of
    the self-attention buffers."""
    return tuple(p(mem).unflatten(-1, (mha.num_heads, -1)).transpose(1, 2)
                 for p in (mha.wk, mha.wv))


def _kv_memory_t(mha, mem):
    """mem (N, Lm, D) -> K (N, H, Dh, Lm), V (N, H, Lm, Dh): K already
    transposed for the beam's cross-attention, which shares one memory
    among the beams of a row (`beam.py`, `x_attend`)."""
    K, V = _kv_memory(mha, mem)
    return K.transpose(-1, -2), V


def _attn_out(mha, ctx):
    """ctx (N, H, Dh) -> (N, D) through the output projection (biased)."""
    return mha.out(ctx.flatten(-2))


def _attend(q, K, V, bias):
    """q (N, H, Dh); K, V (N, H, L, Dh); bias broadcastable to (N, H, L):
    f32 logits q.K / sqrt(Dh) + bias, softmax, weights in V's dtype."""
    logits = torch.matmul(K, q[..., None])[..., 0].float()
    logits = logits / math.sqrt(q.shape[-1]) + bias
    w = torch.softmax(logits, dim=-1).to(V.dtype)
    return torch.matmul(w[:, :, None, :], V)[:, :, 0]


def _layer_step(layer, x, i: int, cache, self_bias, cross: Callable, dtype):
    """Position i through one decoder layer: its K and V are written into
    the buffers `cache` at i (in place), the query attends over them, then
    `cross(q)` attends to the memory, then the FFN (the identity in
    ffn_mode "identity"). -> (N, D) in `dtype`."""
    sa = layer.self_mha
    heads = sa.num_heads
    Kc, Vc = cache
    Kc[:, :, i] = _qkv(sa.wk, x, heads)
    Vc[:, :, i] = _qkv(sa.wv, x, heads)
    attn = _attn_out(sa, _attend(_qkv(sa.wq, x, heads), Kc, Vc, self_bias))
    out1 = _ln(layer.ln1, x + attn).to(dtype)
    ca = layer.cross_mha
    attn2 = _attn_out(ca, cross(_qkv(ca.wq, out1, heads)))
    out2 = _ln(layer.ln2, attn2 + out1).to(dtype)
    return _ln(layer.ln3, layer.ffn(out2) + out2).to(dtype)


class _Prologue:
    """What every KV decode step shares: the activation dtype, the
    decoder's embedding (E[tok] * sqrt(d) + pe[i] in that dtype), empty
    buffers, and the self-attention bias of step i."""

    def __init__(self, model, cfg: Config, device):
        self.dtype = torch_dtype(cfg.dtype)
        self.dec = model.semantic_decoder
        self.T = cfg.max_length
        self.heads = cfg.decoder_num_heads
        self.depth = cfg.decoder_d_model // self.heads
        self.pad_idx = cfg.pad_idx
        # rows of the table do not depend on its length; sized from the
        # config so a max_length above 510 cannot run off it
        self.pe = positional_encoding(max(512, self.T + 2),
                                      cfg.decoder_d_model,
                                      self.dtype)[0].to(device)
        self.positions = torch.arange(self.T + 1, device=device)

    def embed(self, tok, i: int):
        emb = self.dec.embed
        return emb.embedding.weight[tok].to(self.dtype) * emb.sqrt_d \
            + self.pe[i]

    def buffers(self, n: int, device):
        shape = (n, self.heads, self.T + 1, self.depth)
        return [(torch.zeros(shape, dtype=self.dtype, device=device),
                 torch.zeros(shape, dtype=self.dtype, device=device))
                for _ in self.dec.layers]

    def self_bias(self, buf, i: int, neg: float):
        """(N, 1, T+1) f32: keys blocked where causal-future OR where the
        emitted token is <PAD> (the full-prefix decoder's combined mask)."""
        blocked = (self.positions[None, :] > i) | (buf == self.pad_idx)
        return torch.where(blocked, neg, 0.0)[:, None, :]


def _kv_loop(model, cfg: Config) -> Callable:
    """-> `loop(mem (N, Lm, D), enc_padding_mask) -> (N, T+1) int32 ids`."""

    def loop(mem, enc_padding_mask):
        pro = _Prologue(model, cfg, mem.device)
        n, dev = mem.shape[0], mem.device
        mem = mem.to(pro.dtype)
        memKV = [_kv_memory(l.cross_mha, mem) for l in pro.dec.layers]
        cross_bias = enc_padding_mask[:, :, 0, :] * NEG     # (N, 1, Lm)
        W, b = _final_wb(model)
        buf = torch.full((n, pro.T + 1), cfg.pad_idx, dtype=torch.long,
                         device=dev)
        buf[:, 0] = cfg.start_idx
        caches = pro.buffers(n, dev)
        for i in range(pro.T):
            x = pro.embed(buf[:, i], i)
            self_bias = pro.self_bias(buf, i, NEG)
            for layer, cache, (Km, Vm) in zip(pro.dec.layers, caches, memKV):
                x = _layer_step(layer, x, i, cache, self_bias,
                                lambda q: _attend(q, Km, Vm, cross_bias),
                                pro.dtype)
            logits = x.float() @ W.float().t() + b.float()
            buf[:, i + 1] = torch.argmax(logits, dim=-1)
        return buf.to(torch.int32)

    return loop


def make_greedy_decode_kv(model, cfg: Config) -> Callable:
    """KV-cached clean greedy decode at one noise level (vanilla
    transceiver): `decode(inp, pnr_db, n_std, noise) -> (B, max_length+1)
    ids`, `noise` the channel's standard normal (B, L, channel_dim)."""
    return single_level(model, cfg, _kv_loop(model, cfg))


def make_greedy_decode_kv_sweep(model, cfg: Config) -> Callable:
    """KV-cached greedy decode across S noise levels in one call:
    `sweep(inp, pnr_db, n_stds[S], noise[S, B, L, channel_dim])
    -> (S, B, max_length+1) ids`. The JAX package vmaps the decode over the
    noise levels; here the S x B rows are one batch and the encoder runs
    once on the B input rows (`greedy.noise_sweep`)."""
    return noise_sweep(model, cfg, _kv_loop(model, cfg))
