"""Building blocks shared by the port's modules: a Dense layer with flax's
`param_dtype` / `dtype` contract, and dropout drawn from an explicit
generator.

Dense: the weight and bias are held in f32 (the master copy the optimizer
updates) and cast to the activation dtype at every use, as flax computes
with `param_dtype=float32, dtype=bfloat16`. Casting at use gives the same
values as rounding the weights once at load, so a bf16 forward is
unchanged; the gradient reaches the f32 weights through the cast. Without
autograd (serving) the cast copy is kept and reused until the weights
change (a new version or storage), so a decode loop does not cast every
weight at every step.

Dropout (flax `nn.Dropout`): keep each element with probability 1 - rate,
scaling kept ones by 1 / (1 - rate) in the activation dtype. The mask is
drawn with `bernoulli_` from the caller's `torch.Generator`; without one
(or at rate 0) the layer is the identity, as flax's `deterministic=True`.
Nothing draws from the global generator.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


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
        if torch.is_grad_enabled() or self.weight.dtype == self.act_dtype:
            return self._cast_params()
        key = [(p.data_ptr(), p._version) for p in self.parameters()]
        if self._cast is None or self._cast[0] != key:
            self._cast = (key, self._cast_params())
        return self._cast[1]

    def forward(self, x):
        weight, bias = self._params()
        return F.linear(x.to(self.act_dtype), weight, bias)


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout of `x` with masks from `gen` (identity when gen is None or
    rate is 0)."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    mask.bernoulli_(keep, generator=gen)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))
