"""The GAN perturbation networks (JAX package `models/gan.py`):

- `Generator`: Dense hidden (ReLU) -> Dense out_dim -> half-power
  normalization x / sqrt(2 mean(x^2)) in f32: the perturbation the GAN
  transceiver adds at the channel carries half unit power;
- `Discriminator`: a Dense 32 -> 32 -> 16 MLP (the reference defines it
  but its training step never calls it: the receiver plays the
  discriminator; kept for API parity);
- `GeneratorCNN` and `DiscriminatorCNN`: two "SAME" 1-D convolutions over
  the sequence, a LayerNorm over the sequence axis (statistics over L, a
  scale and bias per position), and a Dense; the discriminator applies its
  one LayerNorm twice, with shared parameters, as the reference does.

Parameters are f32 with flax's names (`fc0`, `fc1`, `fc2`, `cnn1`, `cnn2`,
`norm`, `fc`), so the weight bridge (`utils/convert.py`) maps them; a conv
kernel is held as torch's (out, in, width).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deepsc_gan_tpu_torch.models.channel import power_normalize
from deepsc_gan_tpu_torch.ops.layers import Dense
from deepsc_gan_tpu_torch.parallel.batch import dp_group

LN_EPS = 1e-6


class Generator(nn.Module):
    """The reference's `G`."""

    def __init__(self, in_dim=16, hidden=256, out_dim=16,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc0 = Dense(in_dim, hidden, dtype=dtype)
        self.fc1 = Dense(hidden, out_dim, dtype=dtype)

    def forward(self, x):
        x = self.fc1(torch.relu(self.fc0(x)))
        return power_normalize(x.float(), half=True,
                               group=dp_group()).to(self.dtype)


class Discriminator(nn.Module):
    """The reference's `D`."""

    def __init__(self, in_dim=16, hidden=32, out_dim=16,
                 dtype=torch.float32):
        super().__init__()
        self.fc0 = Dense(in_dim, hidden, dtype=dtype)
        self.fc1 = Dense(hidden, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out_dim, dtype=dtype)

    def forward(self, x):
        x = torch.relu(self.fc0(x))
        return self.fc2(torch.relu(self.fc1(x)))


class Conv1dSame(nn.Module):
    """flax `nn.Conv(features, (width,), padding="SAME")` on (B, L, C):
    (width - 1) // 2 zeros before the sequence and the rest after it."""

    def __init__(self, in_ch: int, out_ch: int, width: int,
                 dtype=torch.float32):
        super().__init__()
        self.act_dtype = dtype
        self.pad = ((width - 1) // 2, width - 1 - (width - 1) // 2)
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, width))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        dt = self.act_dtype
        x = F.pad(x.to(dt).transpose(1, 2), self.pad)
        return F.conv1d(x, self.weight.to(dt), self.bias.to(dt)) \
            .transpose(1, 2)


class SequenceLayerNorm(nn.Module):
    """flax `nn.LayerNorm(reduction_axes=1, feature_axes=1)` on (B, L, C):
    mean and variance over the sequence axis (flax's fast variance,
    E[x^2] - E[x]^2 clipped at 0), a scale and bias per position, in f32."""

    def __init__(self, length: int, dtype=torch.float32):
        super().__init__()
        self.act_dtype = dtype
        self.weight = nn.Parameter(torch.ones(length))
        self.bias = nn.Parameter(torch.zeros(length))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=1, keepdim=True)
        var = torch.clamp(torch.square(x).mean(dim=1, keepdim=True)
                          - torch.square(mean), min=0.0)
        y = (x - mean) * torch.rsqrt(var + LN_EPS)
        y = y * self.weight[:, None] + self.bias[:, None]
        return y.to(self.act_dtype)


class GeneratorCNN(nn.Module):
    """The reference's `G_CNN` on (B, `length`, in_dim)."""

    def __init__(self, length: int, in_dim=16, filters=16, width=16,
                 out_dim=16, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cnn1 = Conv1dSame(in_dim, filters, width, dtype)
        self.cnn2 = Conv1dSame(filters, filters, width, dtype)
        self.norm = SequenceLayerNorm(length, dtype)
        self.fc = Dense(filters, out_dim, dtype=dtype)

    def forward(self, x):
        x = self.fc(self.norm(self.cnn2(self.cnn1(x))))
        return power_normalize(x.float(), half=True,
                               group=dp_group()).to(self.dtype)


class DiscriminatorCNN(nn.Module):
    """The reference's `D_CNN` on (B, `length`, in_dim); `norm` runs twice."""

    def __init__(self, length: int, in_dim=16, filters=16, width=8,
                 hidden=128, dtype=torch.float32):
        super().__init__()
        self.cnn1 = Conv1dSame(in_dim, filters, width, dtype)
        self.cnn2 = Conv1dSame(filters, filters, width, dtype)
        self.norm = SequenceLayerNorm(length, dtype)
        self.fc = Dense(filters, hidden, dtype=dtype)

    def forward(self, x):
        x = self.norm(self.cnn2(self.cnn1(x)))
        return self.norm(self.fc(x))
