"""Attention mask builders (JAX package `ops/masks.py:17-36`): float
masks with 1.0 at positions to BLOCK; the padding mask is (B, 1, 1, L),
the look-ahead mask (L, L), the combined decoder mask max(pad, causal)."""

from __future__ import annotations

import torch


def create_padding_mask(seq: torch.Tensor, pad_idx: int = 0) -> torch.Tensor:
    """(B, L) int tokens -> (B, 1, 1, L) float mask, 1.0 where PAD."""
    return (seq == pad_idx).to(torch.float32)[:, None, None, :]


def create_look_ahead_mask(size: int, device=None) -> torch.Tensor:
    """(L, L) float mask, 1.0 strictly above the diagonal."""
    ones = torch.ones((size, size), dtype=torch.float32, device=device)
    return 1.0 - torch.tril(ones)


def create_masks(inp: torch.Tensor, tar: torch.Tensor, pad_idx: int = 0):
    """-> (enc_padding_mask, combined_mask, dec_padding_mask)."""
    enc_padding_mask = create_padding_mask(inp, pad_idx)
    dec_padding_mask = create_padding_mask(inp, pad_idx)
    look_ahead = create_look_ahead_mask(tar.shape[1], tar.device)
    combined = torch.maximum(create_padding_mask(tar, pad_idx), look_ahead)
    return enc_padding_mask, combined, dec_padding_mask
