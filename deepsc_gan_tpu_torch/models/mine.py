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
import torch.distributed as dist
from torch import nn

from deepsc_gan_tpu_torch.parallel.batch import all_max, all_sum, gather_rows


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


def sample_batch(x: torch.Tensor, y: torch.Tensor, perm: torch.Tensor,
                 group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The marginal pairing: (x, y re-ordered by `perm` along the batch),
    so (x, y[perm]) ~ p(x) p(y). The joint pairs are (x, y). With a dp
    `group`, x and y are a rank's rows of the global batch and `perm` the
    global batch's permutation: the rank's rows of the pairing are its x
    and the global y (gathered, differentiable) at its rows of `perm`."""
    if group is None:
        return x, y[perm]
    b = x.shape[0]
    index = dist.get_rank(group)
    return x, gather_rows(y, group)[perm[index * b:(index + 1) * b]]


def mutual_information(t_joint: torch.Tensor, t_marginal: torch.Tensor,
                       group=None) -> torch.Tensor:
    """The Donsker-Varadhan lower bound from T's outputs on the joint and
    the marginal pairs: mean(T_joint) - (logsumexp(T_marg) - log B). With
    a dp `group`, the outputs are a rank's rows and the bound is the global
    batch's: the joint sum, the marginal exponentials' sum (shifted by the
    global maximum) and B summed over the group (differentiable)."""
    if group is None:
        return t_joint.mean() - (torch.logsumexp(t_marginal, dim=0)
                                 - math.log(t_marginal.shape[0]))
    shift = all_max(t_marginal.max(), group)
    count = torch.tensor(float(t_joint.shape[0]), dtype=t_joint.dtype,
                         device=t_joint.device)
    joint, marg, b = all_sum(torch.stack([
        t_joint.sum(), torch.exp(t_marginal - shift).sum(), count]), group)
    return joint / b - (torch.log(marg) + shift - torch.log(b))


def mine_loss(mine: MINE, x: torch.Tensor, y: torch.Tensor,
              perm: torch.Tensor, group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (T's loss, -MI, and the MI estimate) on the pairs of x and y, the
    marginal ones by `perm` (over the global batch with a dp `group`)."""
    xm, ym = sample_batch(x, y, perm, group)
    mi = mutual_information(mine(x, y), mine(xm, ym), group)
    return -mi, mi
