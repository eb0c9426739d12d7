"""Gray-mapped square M-QAM with max-log LLR demapping (JAX package
`baselines/modem.py`), numpy on the host. Square QAM is two Gray-coded PAM
axes, so each bit's LLR is computed on its axis:
  LLR_i = [min_{a: bit_i(a)=1} (y-a)^2 - min_{a: bit_i(a)=0} (y-a)^2]
          / (2 sigma_axis^2)
(positive: bit 0 more likely)."""

from __future__ import annotations

import numpy as np


def _gray(n: int) -> np.ndarray:
    return np.arange(n) ^ (np.arange(n) >> 1)


class QamModem:
    """bits_per_symbol 2, 4 or 6: QPSK, 16-QAM or 64-QAM, unit average
    symbol energy."""

    def __init__(self, bits_per_symbol: int = 6):
        if bits_per_symbol % 2 or bits_per_symbol < 2:
            raise ValueError("square QAM needs even bits_per_symbol >= 2")
        self.m = bits_per_symbol
        self.axis_bits = bits_per_symbol // 2
        n = 1 << self.axis_bits
        levels = (2.0 * np.arange(n) - (n - 1))
        self._scale = float(np.sqrt(2.0 * np.mean(levels**2)))
        levels /= self._scale  # per axis; two axes -> unit symbol energy
        # bit-group value g -> amplitude: the position of g in Gray order
        order = np.argsort(_gray(n))
        self.amp = levels[order]
        # demap tables: level position i carries the bit pattern gray(i)
        self.level_bits = np.array(
            [[(g >> (self.axis_bits - 1 - b)) & 1
              for b in range(self.axis_bits)] for g in _gray(n)])
        self.level_amp = levels

    def modulate(self, bits: np.ndarray) -> np.ndarray:
        """Flat bits -> (n_sym,) complex symbols, zero-padded."""
        bits = np.asarray(bits, dtype=np.int64).ravel()
        n_sym = (len(bits) + self.m - 1) // self.m
        padded = np.zeros(n_sym * self.m, dtype=np.int64)
        padded[: len(bits)] = bits
        groups = padded.reshape(n_sym, 2, self.axis_bits)
        vals = np.zeros((n_sym, 2), dtype=np.int64)
        for b in range(self.axis_bits):
            vals = (vals << 1) | groups[..., b]
        return self.amp[vals[:, 0]] + 1j * self.amp[vals[:, 1]]

    def llr(self, y: np.ndarray, sigma: float) -> np.ndarray:
        """Received complex symbols and the noise std (total power sigma^2
        per complex dimension) -> flat f32 bit LLRs."""
        var_axis = 0.5 * sigma * sigma
        out = np.empty((len(y), 2, self.axis_bits), dtype=np.float32)
        for axis, ys in enumerate((y.real, y.imag)):
            d2 = (ys[:, None] - self.level_amp[None, :]) ** 2
            for b in range(self.axis_bits):
                mask1 = self.level_bits[:, b] == 1
                m0 = d2[:, ~mask1].min(1)
                m1 = d2[:, mask1].min(1)
                out[:, axis, b] = (m1 - m0) / (2.0 * var_axis)
        return out.reshape(-1)
