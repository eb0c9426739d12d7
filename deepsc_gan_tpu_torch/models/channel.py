"""AWGN channel and the dense channel codec (JAX package
`models/channel.py`). The channel takes its standard-normal noise as an
explicit tensor, so a caller (or a parity test) decides where the random
numbers come from. Rayleigh and Rician fading are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from deepsc_gan_tpu_torch.models.transformer import LayerNorm
from deepsc_gan_tpu_torch.ops.layers import Dense


def snr_to_noise(snr_db) -> torch.Tensor:
    """SNR in dB -> noise std, in f32."""
    snr = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32) / 10.0)
    return 1.0 / torch.sqrt(snr)


def awgn(x: torch.Tensor, noise: torch.Tensor, n_std,
         p: Optional[torch.Tensor] = None, pnr_db: float = 0.0
         ) -> torch.Tensor:
    """y = x + n_std * noise + n_std * sqrt(PNR) * (sqrt(size) * p), in f32.

    `noise` is standard normal, shaped like x (or broadcasting against it
    with leading noise-level axes); `n_std` broadcasts against it. `p` is
    the perturbation; None means zero, where the term is exactly 0."""
    x = x.to(torch.float32)
    n_std = torch.as_tensor(n_std, dtype=torch.float32, device=x.device)
    y = x + n_std * noise
    if p is not None:
        f32 = {"dtype": torch.float32, "device": x.device}
        pnr = 10.0 ** (torch.tensor(pnr_db, **f32) / 10.0)
        size = torch.tensor(float(x.numel()), **f32)
        y = y + n_std * torch.sqrt(pnr) * (torch.sqrt(size) * p)
    return y


def power_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / sqrt(mean(x^2)): unit average power over the WHOLE tensor
    (every row of the batch shares one normalizer)."""
    return x / torch.sqrt(torch.mean(torch.square(x)))


class ChannelEncoder(nn.Module):
    """Dense hidden (ReLU) -> Dense out_dim -> power normalization in f32."""

    def __init__(self, d_model=128, hidden=256, out_dim=16,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dense0 = Dense(d_model, hidden, dtype=dtype)
        self.dense1 = Dense(hidden, out_dim, dtype=dtype)

    def forward(self, x):
        x = self.dense1(torch.relu(self.dense0(x)))
        return power_normalize(x.float()).to(self.dtype)


class ChannelDecoder(nn.Module):
    """Dense d_model (ReLU) -> Dense hidden (ReLU) -> Dense d_model, then
    LayerNorm over the residual (x1 + x3)."""

    def __init__(self, in_dim=16, d_model=128, hidden=512,
                 dtype=torch.float32):
        super().__init__()
        self.dense1 = Dense(in_dim, d_model, dtype=dtype)
        self.dense2 = Dense(d_model, hidden, dtype=dtype)
        self.dense3 = Dense(hidden, d_model, dtype=dtype)
        self.layernorm1 = LayerNorm(d_model, dtype)

    def forward(self, y):
        x1 = torch.relu(self.dense1(y))
        x3 = self.dense3(torch.relu(self.dense2(x1)))
        return self.layernorm1(x1 + x3)
