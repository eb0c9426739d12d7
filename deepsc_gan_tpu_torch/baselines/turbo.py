"""Rate-1/3 turbo code with an iterative max-log-MAP (BCJR) decoder (JAX
package `baselines/turbo.py`).

- Constituent code: the 4-state recursive systematic convolutional (RSC)
  encoder, generators (7, 5) octal (feedback 1+D+D^2, parity 1+D^2). Two
  of them over (u, interleave(u)) give the systematic and two parity
  streams. Encoding is numpy on the host.
- Decoder: max-log-MAP BCJR on the device, a forward (alpha) and a
  backward (beta) recursion of K steps over (B, 4) tensors, sequential in k
  and batched over blocks and states, as the JAX package's two `lax.scan`s:
  alpha starts in state 0 (the others at -1e9), beta uniform at the
  unterminated end, each step's metrics less their largest. The extrinsic
  information goes between the two constituent decoders for `iters`
  rounds through a fixed pseudo-random interleaver.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

# 4-state RSC(7,5) trellis. State s = s1*2 + s2 for register (s1, s2);
# input bit u: a = u^s1^s2 (feedback 7), parity p = a^s2 (feedforward 5),
# next state (a, s1).
_NS = np.zeros((4, 2), dtype=np.int64)   # next state
_PB = np.zeros((4, 2), dtype=np.int64)   # parity bit
for _s in range(4):
    _s1, _s2 = _s >> 1, _s & 1
    for _u in range(2):
        _a = _u ^ _s1 ^ _s2
        _PB[_s, _u] = _a ^ _s2
        _NS[_s, _u] = (_a << 1) | _s1
# for each next state s', the two (previous state, input) pairs into it
_PREV_S = np.zeros((4, 2), dtype=np.int64)
_PREV_U = np.zeros((4, 2), dtype=np.int64)
_cnt = [0, 0, 0, 0]
for _s in range(4):
    for _u in range(2):
        _ns = _NS[_s, _u]
        _PREV_S[_ns, _cnt[_ns]] = _s
        _PREV_U[_ns, _cnt[_ns]] = _u
        _cnt[_ns] += 1
assert _cnt == [2, 2, 2, 2]

_NEG = -1e9


def rsc_encode(u: np.ndarray) -> np.ndarray:
    """Parity stream of the RSC(7,5) encoder: u (..., K) bits -> (..., K)
    uint8."""
    u = np.asarray(u, dtype=np.int64)
    out = np.zeros_like(u)
    s1 = np.zeros(u.shape[:-1], dtype=np.int64)
    s2 = np.zeros_like(s1)
    for k in range(u.shape[-1]):
        a = u[..., k] ^ s1 ^ s2
        out[..., k] = a ^ s2
        s1, s2 = a, s1
    return out.astype(np.uint8)


@torch.inference_mode()
def bcjr(l_sys: torch.Tensor, l_par: torch.Tensor,
         l_apr: torch.Tensor) -> torch.Tensor:
    """Max-log-MAP BCJR over the 4-state trellis: systematic, parity and
    a-priori LLRs (B, K) f32 (positive: bit 0) -> the a-posteriori LLRs of
    the systematic bits (B, K). Unterminated trellis: alpha_0 in state 0,
    beta_K uniform."""
    dev = l_sys.device
    ns = torch.as_tensor(_NS, device=dev)
    prev_s = torch.as_tensor(_PREV_S, device=dev)
    prev_u = torch.as_tensor(_PREV_U, device=dev)
    x_u = 1.0 - 2.0 * torch.arange(2.0, device=dev)
    x_p = 1.0 - 2.0 * torch.as_tensor(_PB, dtype=torch.float32, device=dev)
    B, K = l_sys.shape
    # every step's branch metrics at once: (K, B, 4 states, 2 inputs)
    g = 0.5 * (l_apr + l_sys).t()[:, :, None, None] * x_u
    g = g + 0.5 * l_par.t()[:, :, None, None] * x_p
    g_in = g[:, :, prev_s, prev_u]          # the branches into each state
    alphas = torch.empty((K, B, 4), device=dev)
    alpha = torch.full((B, 4), _NEG, device=dev)
    alpha[:, 0] = 0.0
    for k in range(K):
        alphas[k] = alpha
        new = (alpha[:, prev_s] + g_in[k]).amax(-1)
        alpha = new - new.amax(-1, keepdim=True)
    betas = torch.empty((K, B, 4), device=dev)
    beta = torch.zeros((B, 4), device=dev)
    for k in range(K - 1, -1, -1):
        betas[k] = beta
        new = (beta[:, ns] + g[k]).amax(-1)
        beta = new - new.amax(-1, keepdim=True)
    m = alphas[..., None] + g + betas[:, :, ns]          # (K, B, 4, 2)
    return (m[..., 0].amax(-1) - m[..., 1].amax(-1)).t()


class TurboCodec:
    """Rate-1/3 turbo codec over blocks of `block_k` bits; the decoder runs
    `iters` rounds of the two constituent BCJRs on `device` (CUDA unless
    another is named)."""

    def __init__(self, block_k: int = 1024, iters: int = 6, seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.block_k = block_k
        self.iters = iters
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(block_k)
        self.inv_perm = np.argsort(self.perm)
        self.device = torch.device("cuda" if device is None else device)

    def encode(self, bits: np.ndarray) -> tuple[np.ndarray, int]:
        """Flat uint8 bits -> ((3, n_blocks, K) BPSK +-1 f32, n_bits): the
        systematic stream, parity 1, parity 2 (of the interleaved input)."""
        bits = np.asarray(bits, dtype=np.uint8).ravel()
        n = len(bits)
        k = self.block_k
        n_blocks = (n + k - 1) // k
        u = np.zeros((n_blocks, k), dtype=np.uint8)
        u.ravel()[:n] = bits
        p1 = rsc_encode(u)
        p2 = rsc_encode(u[:, self.perm])
        sym = 1.0 - 2.0 * np.stack([u, p1, p2]).astype(np.float32)
        return sym, n

    @torch.inference_mode()
    def decode(self, llr, n_bits: int) -> np.ndarray:
        """(3, n_blocks, K) channel LLRs -> the first `n_bits` bits decided
        on the last round's a-posteriori LLRs, flat uint8."""
        l_sys, l_p1, l_p2 = torch.as_tensor(
            np.asarray(llr), dtype=torch.float32, device=self.device)
        perm = torch.as_tensor(self.perm, device=self.device)
        inv = torch.as_tensor(self.inv_perm, device=self.device)
        l_sys_i = l_sys[:, perm]
        apr = torch.zeros_like(l_sys)
        full2 = None
        for _ in range(self.iters):
            full1 = bcjr(l_sys, l_p1, apr)
            apr2 = (full1 - apr - l_sys)[:, perm]
            full2 = bcjr(l_sys_i, l_p2, apr2)
            apr = (full2 - apr2 - l_sys_i)[:, inv]
        hard = (full2[:, inv] < 0).to(torch.uint8).cpu().numpy()
        return hard.ravel()[:n_bits]

    @staticmethod
    def awgn_llr(sym: np.ndarray, snr_db: float,
                 normals: Union[torch.Tensor, torch.Generator],
                 attack_pnr_db: Optional[float] = None) -> np.ndarray:
        """BPSK over AWGN at Es/N0 = snr_db -> channel LLRs 2y/sigma^2.
        `normals` is the standard-normal draw shaped like `sym` (a tensor),
        or a CPU generator to draw it from. `attack_pnr_db` adds a
        perturbation against each transmitted symbol at that
        perturbation-to-noise ratio (for BPSK the FGM direction)."""
        sigma = float(1.0 / np.sqrt(10.0 ** (snr_db / 10.0)))
        if isinstance(normals, torch.Generator):
            normals = torch.randn(sym.shape, generator=normals)
        noise = sigma * normals.detach().to(torch.float32).cpu().numpy()
        y = sym + noise
        if attack_pnr_db is not None:
            amp = sigma * np.sqrt(10.0 ** (attack_pnr_db / 10.0))
            y = y - amp * np.sign(sym)
        return 2.0 * y / (sigma * sigma)
