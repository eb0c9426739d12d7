"""The channels (AWGN, Rayleigh and Rician fading) and the dense channel
codec (JAX package `models/channel.py`). A channel takes its standard-normal
draws as explicit tensors (the noise, and for fading the fade), so a caller
(or a parity test) decides where the random numbers come from.

Fading (Rayleigh K = 0, Rician K = 1) reads the signal as interleaved
complex pairs (re, im) along its last axes, multiplies them by a complex
fade h = mean + std * fade (one per call, or one per batch row with
`fading_per_sample`) and adds complex noise, the noise draw read as pairs
the same way. Quirk Q3, as the reference: without an equalizer the
un-equalized y is returned; `p` and `pnr_db` are accepted and ignored on
the fading path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from deepsc_gan_tpu_torch.models.transformer import LayerNorm
from deepsc_gan_tpu_torch.ops.layers import Dense
from deepsc_gan_tpu_torch.parallel.batch import all_sum, dp_group, draw_rows


def f32_scalar(value, device) -> torch.Tensor:
    """`value` in f32 for arithmetic with tensors on `device`: a tensor
    moved there (no copy when it is there already), a Python number as a
    0-dim CPU tensor, which a CUDA kernel takes as a scalar argument: no
    host-to-device copy, so a captured CUDA graph may hold it, and the same
    f32 value the number rounds to."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.tensor(value, dtype=torch.float32)


def snr_to_noise(snr_db) -> torch.Tensor:
    """SNR in dB -> noise std, in f32."""
    snr = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32) / 10.0)
    return 1.0 / torch.sqrt(snr)


def awgn(x: torch.Tensor, noise: torch.Tensor, n_std,
         p: Optional[torch.Tensor] = None, pnr_db: float = 0.0,
         group=None) -> torch.Tensor:
    """y = x + n_std * noise + n_std * sqrt(PNR) * (sqrt(size) * p), in f32.

    `noise` is standard normal, shaped like x (or broadcasting against it
    with leading noise-level axes); `n_std` broadcasts against it. `p` is
    the perturbation; None means zero, where the term is exactly 0. `size`
    is the whole batch's element count: x's times the dp `group`'s size
    when x is a rank's rows."""
    x = x.to(torch.float32)
    n_std = f32_scalar(n_std, x.device)
    y = x + n_std * noise
    if p is not None:
        f32 = {"dtype": torch.float32, "device": x.device}
        pnr = 10.0 ** (torch.tensor(pnr_db, **f32) / 10.0)
        ranks = 1 if group is None else dist.get_world_size(group)
        size = torch.tensor(float(x.numel() * ranks), **f32)
        y = y + n_std * torch.sqrt(pnr) * (torch.sqrt(size) * p)
    return y


EQUALIZERS = (None, "LS", "MMSE")


def fading(x: torch.Tensor, fade: torch.Tensor, noise: torch.Tensor, n_std,
           k_factor: float = 0.0, equalizer: Optional[str] = None
           ) -> torch.Tensor:
    """Flat fading with Rician factor `k_factor` (0: Rayleigh), in f32
    real arithmetic on (re, im) pairs.

    x (..., B, L, C) and the standard-normal `noise` broadcast to the
    output's shape (leading noise-level axes allowed, as the sweeps give);
    `n_std` broadcasts against it. `fade` is standard normal: (..., 2) for
    one complex fade per call (per leading index), or (..., B, 1, 2) for
    one per batch row. h = mean + std * fade with mean = sqrt(K / (2 (K +
    1))) and std = sqrt(1 / (2 (K + 1))); y = x h + n_std * noise; `equalizer`
    "LS" returns y conj(h) / |h|^2, "MMSE" y conj(h) / (|h|^2 + 2 n_std^2)."""
    if equalizer not in EQUALIZERS:
        raise ValueError("equalizer must be None, 'LS' or 'MMSE'")
    x = x.to(torch.float32)
    n_std = f32_scalar(n_std, x.device)
    shape = torch.broadcast_shapes(x.shape, noise.shape)
    xp = x.reshape(x.shape[:-2] + (-1, 2))
    npair = noise.reshape(noise.shape[:-2] + (-1, 2))
    if fade.dim() < len(shape):     # one fade per call: (..., 2)
        fade = fade[..., None, None, :]
    mean = math.sqrt(k_factor / (2.0 * (k_factor + 1.0)))
    std = math.sqrt(1.0 / (2.0 * (k_factor + 1.0)))
    h = mean + std * fade.to(torch.float32)
    # the last axis kept at size 1, so n_std (S, 1, 1, 1) broadcasts
    xr, xi = xp[..., :1], xp[..., 1:]
    hr, hi = h[..., :1], h[..., 1:]
    yr = xr * hr - xi * hi + n_std * npair[..., :1]
    yi = xr * hi + xi * hr + n_std * npair[..., 1:]
    if equalizer is not None:
        h2 = hr * hr + hi * hi
        if equalizer == "MMSE":
            h2 = h2 + n_std * n_std * 2.0
        yr, yi = (yr * hr + yi * hi) / h2, (yi * hr - yr * hi) / h2
    return torch.cat([yr, yi], dim=-1).reshape(shape)


def channel(x: torch.Tensor, noise: torch.Tensor, n_std,
            p: Optional[torch.Tensor] = None, pnr_db: float = 0.0,
            kind: str = "AWGN", fade: Optional[torch.Tensor] = None,
            equalizer: Optional[str] = None) -> torch.Tensor:
    """The reference's dispatch: "AWGN" | "Rayleigh" (K = 0) | anything else
    Rician (K = 1). A fading channel needs its `fade` draw. Under a
    data-parallel shard (`parallel/batch.py`) the perturbation's scale
    counts the global batch."""
    if kind == "AWGN":
        return awgn(x, noise, n_std, p, pnr_db, dp_group())
    if fade is None:
        raise ValueError(f"the {kind} channel needs its fade draw")
    return fading(x, fade, noise, n_std, 0.0 if kind == "Rayleigh" else 1.0,
                  equalizer)


def draw_channel(generator: torch.Generator, shape, kind: str = "AWGN",
                 per_sample: bool = False, lead=()):
    """-> (noise, fade): the standard-normal noise `shape` (B, L, C) with
    leading axes `lead`, then for a fading `kind` the standard-normal fade
    ((*lead, 2), or (*lead, B, 1, 2) `per_sample`), else None; both f32 from
    `generator` on its device, in that order, so an AWGN channel draws the
    noise alone. Under a data-parallel shard B is the rank's rows: the
    global batch's values are drawn and the rank's rows kept."""
    f32 = {"generator": generator, "device": generator.device,
           "dtype": torch.float32}
    lead = tuple(lead)

    def randn(s):
        return torch.randn(s, **f32)

    noise = draw_rows(randn, lead + tuple(shape), len(lead))
    if kind == "AWGN":
        return noise, None
    if per_sample:
        return noise, draw_rows(randn, lead + (shape[0], 1, 2), len(lead))
    return noise, randn(lead + (2,))


def power_normalize(x: torch.Tensor, half: bool = False,
                    group=None) -> torch.Tensor:
    """x / sqrt(mean(x^2)): unit average power over the WHOLE tensor
    (every row of the batch shares one normalizer); with `half`,
    x / sqrt(2 mean(x^2)), half unit power (the GAN generator's). With a
    dp `group`, x is a rank's rows and the mean is the global batch's: a
    sum of squares and a count summed over the group (differentiable)."""
    scale = 2.0 if half else 1.0
    if group is None:
        return x / torch.sqrt(scale * torch.mean(torch.square(x)))
    count = torch.tensor(float(x.numel()), dtype=x.dtype, device=x.device)
    stats = all_sum(torch.stack([torch.sum(torch.square(x)), count]), group)
    return x / torch.sqrt(scale * (stats[0] / stats[1]))


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
        return power_normalize(x.float(), group=dp_group()).to(self.dtype)


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
