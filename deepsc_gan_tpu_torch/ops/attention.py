"""Multi-head attention (JAX package `ops/attention.py`, the fused-kernel
path at :147-185): bias-free Q/K/V projections to a 3-D (B, L, H*Dh)
layout, the mask collapsed to one additive f32 bias (B, Lq, Lk) of
-1e9 * mask shared by the heads, the fused attention kernel, and a biased
output projection.

Weights are f32 and cast to the activation dtype at every use, as flax
computes (`ops/layers.py:Dense`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from deepsc_gan_tpu_torch.ops.attention_kernel import fused_attention
from deepsc_gan_tpu_torch.ops.layers import Dense

NEG_INF = -1e9


def mask_to_bias(mask: Optional[torch.Tensor], b: int, lq: int, lk: int,
                 device=None) -> torch.Tensor:
    """(B,1,1,Lk) pad, (B,1,Lq,Lk) combined or (Lq,Lk) causal mask
    (1.0 = blocked) -> contiguous additive f32 bias (B, Lq, Lk)."""
    if mask is None:
        return torch.zeros((b, lq, lk), dtype=torch.float32, device=device)
    mb = mask.to(torch.float32) * NEG_INF
    if mb.dim() == 4:
        mb = mb[:, 0]
    return mb.expand(b, lq, lk).contiguous()


class MultiHeadAttention(nn.Module):
    """`attention` is the per-call attention function (the kernels by
    default; chip_smoke.py passes the plain versions to compare whole
    decodes and train steps)."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 attention: Callable = fused_attention):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.depth = d_model // num_heads
        self.attention = attention
        hd = num_heads * self.depth
        self.wq = Dense(d_model, hd, bias=False, dtype=dtype)
        self.wk = Dense(d_model, hd, bias=False, dtype=dtype)
        self.wv = Dense(d_model, hd, bias=False, dtype=dtype)
        self.out = Dense(hd, d_model, bias=True, dtype=dtype)

    def forward(self, q, k, v, mask=None):
        b, lq = q.shape[0], q.shape[1]
        lk = k.shape[1]
        qp = self.wq(q)
        kp = self.wk(k)
        vp = self.wv(v)
        bias = mask_to_bias(mask, b, lq, lk, q.device)
        ctx = self.attention(qp, kp, vp, bias, self.num_heads,
                             math.sqrt(self.depth))
        return self.out(ctx)
