"""Sinusoidal absolute positional encoding (JAX package
`ops/positional.py:14-23`): angle(pos, i) = pos / 10000^(2i/d_model) with
the RAW channel index i (a reference quirk kept for parity), sin on even
channels, cos on odd, shape (1, positions, d_model)."""

from __future__ import annotations

import numpy as np
import torch


def positional_encoding(position: int, d_model: int,
                        dtype=torch.float32) -> torch.Tensor:
    pos = np.arange(position)[:, None].astype(np.float32)
    i = np.arange(d_model)[None, :].astype(np.float32)
    angles = pos / np.power(10000.0, (2.0 * i) / np.float32(d_model))
    angles[:, 0::2] = np.sin(angles[:, 0::2])
    angles[:, 1::2] = np.cos(angles[:, 1::2])
    return torch.from_numpy(angles[None, ...]).to(dtype)
