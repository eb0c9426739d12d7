"""MINE, mutual information neural estimation (JAX package
`models/mine.py`): a statistics network T(x, y) trained so that

    I(X; Y) >= E_joint[T] - log E_marginal[e^T]

(the Donsker-Varadhan bound) between the transmitted channel symbols x
and the received symbols y. MINE training (`train/mine_steps.py`) raises
the bound with T's parameters, and the transceiver's loss takes
`- mine_lambda * MI` so the codec keeps mutual information across the
channel.

`MINE` is the JAX module's three-Dense MLP under flax's names (`fc0`,
`fc1`, `fc2`), in f32 whatever the transceiver's activation dtype; its
parameters go through the weight bridge as any Dense's
(`utils/convert.py`). The marginal pairing's permutation is an explicit
tensor, so a test hands both packages the same one.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn


class MINE(nn.Module):
    """Statistics network T(x, y): an MLP (ReLU, `hidden` wide, twice) on
    x and y flattened per row and concatenated; `in_features` is their
    summed width (2 * seq_len * channel_dim for the transceiver's
    symbols). -> (B,) f32."""

    def __init__(self, in_features: int, hidden: int = 256):
        super().__init__()
        self.fc0 = nn.Linear(in_features, hidden)
        self.fc1 = nn.Linear(hidden, hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        inputs = torch.cat([x.reshape(b, -1), y.reshape(b, -1)],
                           dim=-1).float()
        h = torch.relu(self.fc0(inputs))
        h = torch.relu(self.fc1(h))
        return self.fc2(h)[:, 0]


def sample_batch(x: torch.Tensor, y: torch.Tensor, perm: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The marginal pairing: (x, y re-ordered by `perm` along the batch),
    so (x, y[perm]) ~ p(x) p(y). The joint pairs are (x, y)."""
    return x, y[perm]


def mutual_information(t_joint: torch.Tensor,
                       t_marginal: torch.Tensor) -> torch.Tensor:
    """The Donsker-Varadhan lower bound from T's outputs on the joint and
    the marginal pairs: mean(T_joint) - (logsumexp(T_marg) - log B)."""
    return t_joint.mean() - (torch.logsumexp(t_marginal, dim=0)
                             - math.log(t_marginal.shape[0]))


def mine_loss(mine: MINE, x: torch.Tensor, y: torch.Tensor,
              perm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (T's loss, -MI, and the MI estimate) on the pairs of x and y, the
    marginal ones by `perm`."""
    xm, ym = sample_batch(x, y, perm)
    mi = mutual_information(mine(x, y), mine(xm, ym))
    return -mi, mi
