"""Building blocks shared by the port's modules: a Dense layer with flax's
`param_dtype` / `dtype` contract, the packed projection of several
bias-free Denses that share an input (`fuse_qkv`), and dropout drawn from
an explicit generator.

Dense: the weight and bias are held in f32 (the master copy the optimizer
updates) and cast to the activation dtype at every use, as flax computes
with `param_dtype=float32, dtype=bfloat16`. Casting at use gives the same
values as rounding the weights once at load, so a bf16 forward is
unchanged; the gradient reaches the f32 weights through the cast. Without
autograd (serving) the cast copy is kept and reused until the weights
change (a new version or storage), so a decode loop does not cast every
weight at every step; a program being traced (`torch.export`) casts at
every use.

Dropout (flax `nn.Dropout`): keep each element with probability 1 - rate,
scaling kept ones by 1 / (1 - rate) in the activation dtype. The mask is
drawn with `bernoulli_` from the caller's `torch.Generator`; without one
(or at rate 0) the layer is the identity, as flax's `deterministic=True`.
Nothing draws from the global generator. Under a data-parallel shard
(`parallel/batch.py`) a mask is the global batch's, the rank's rows kept.
A layer recomputed in the backward (`remat`) draws through a `MaskTape`
instead of the generator:
the first forward draws its masks from the generator in the same order and
keeps them, and the recompute takes the kept ones, so the masks and the
generator's state are those of a layer that is not recomputed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepsc_gan_tpu_torch.parallel.batch import draw_rows


class Dense(nn.Linear):
    """`nn.Linear` with f32 parameters computed in `dtype`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.act_dtype = dtype
        self._cast = None  # (key, weight, bias) in act_dtype, no-grad use

    def _cast_params(self):
        dt = self.act_dtype
        return (self.weight.to(dt),
                None if self.bias is None else self.bias.to(dt))

    def _params(self):
        """(weight, bias) in the activation dtype."""
        if torch.is_grad_enabled() or self.weight.dtype == self.act_dtype \
                or torch.compiler.is_compiling():
            # (a traced program, as `torch.export`'s, casts in its graph)
            return self._cast_params()
        key = [(p.data_ptr(), p._version) for p in self.parameters()]
        if self._cast is None or self._cast[0] != key:
            self._cast = (key, self._cast_params())
        return self._cast[1]

    def forward(self, x):
        weight, bias = self._params()
        return F.linear(x.to(self.act_dtype), weight, bias)


def project_packed(x: torch.Tensor, denses) -> tuple:
    """The projections of `x` by the bias-free Denses `denses` (the same
    input and output widths) as ONE matmul of x against their stacked
    weights, in the activation dtype (the JAX package's `project_packed`,
    `ops/attention.py`): -> one contiguous, 16-byte aligned tensor per
    Dense, x's leading shape by its output width. The parameters stay the
    Denses' own."""
    dt = denses[0].act_dtype
    w = torch.stack([d.weight for d in denses]).to(dt)   # (n, out, in)
    out = torch.matmul(x.to(dt).reshape(1, -1, x.shape[-1]),
                       w.transpose(1, 2))                 # (n, rows, out)
    parts = [o.view(*x.shape[:-1], o.shape[-1]) for o in out]
    if not torch.compiler.is_compiling() \
            and any(t.data_ptr() % 16 for t in parts):
        parts = [t.clone() for t in parts]
    return tuple(parts)


class MaskTape:
    """The dropout draws of one layer call that is recomputed in the
    backward: the first forward draws each mask from `gen` (as `dropout`
    would) and keeps it; each recompute (`rewind`) takes the kept masks in
    the same order and draws nothing."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self.kept = []
        self.recorded = False
        self._next = 0

    def rewind(self) -> None:
        """Start a recompute: the next masks are the kept ones."""
        self._next = 0

    def mask(self, shape, keep: float, device) -> torch.Tensor:
        if self.recorded:
            self._next += 1
            return self.kept[self._next - 1]
        mask = _draw_mask(shape, keep, device, self.gen).bool()
        self.kept.append(mask)
        return mask


def _draw_mask(shape, keep: float, device, gen: torch.Generator):
    """A keep mask of `shape`, batch-leading: under a data-parallel shard
    the global batch's mask is drawn and the rank's rows kept."""

    def draw(s):
        mask = torch.empty(s, dtype=torch.float32, device=device)
        return mask.bernoulli_(keep, generator=gen)

    return draw_rows(draw, shape)


def dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """Dropout of `x` with masks from `gen`, a `torch.Generator` or a
    `MaskTape` (identity when gen is None or rate is 0)."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(gen, MaskTape):
        mask = gen.mask(x.shape, keep, x.device)
    else:
        mask = _draw_mask(x.shape, keep, x.device, gen)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))
