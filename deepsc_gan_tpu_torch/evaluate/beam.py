"""Beam search for the vanilla transceiver (JAX package `evaluate/beam.py`).

State per row: tokens (B, K, T+1), cumulative log-probs (B, K) and finished
flags (B, K); the K beams fold into the batch for the decoder. Step i:
decode the B*K prefixes, score candidates with the fused top-K scorer
(`ops/topk_kernel.py`, kernel K6: vocab projection, per-beam top K and
logsumexp, the logits never in memory), take the top K of the K*K
candidates per row, and follow the surviving beams.

The two-stage selection is exact: a global top-K continuation is within its
beam's top K over the vocab, both stages rank `score + (logit - lse)`, and
ties go to the lowest flat (beam-major) index, as a one-stage masked argmax
over K*V would. Finished beams (they emitted <END>) are frozen: they propose
one continuation, <PAD>, carrying their score. Scores are sums of log-probs
with no length normalisation, so beam size 1 is greedy up to <END>.

- `make_beam_decode`: the full-prefix decoder at every step (the oracle);
- `make_beam_decode_kv`: the serving path, per-layer K/V buffers
  (`evaluate/kv_decode.py`) that follow the surviving beams;
- `make_beam_decode_sweep`: the KV beam across S noise levels in one call,
  the S x B rows folded into the batch, the beams of a row at one level.

Both decoders score through the same `topk` function (K6 by default), so the
scorer's numerics cancel when they are compared.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from deepsc_gan_tpu_torch.evaluate.greedy import noise_sweep, single_level
from deepsc_gan_tpu_torch.evaluate.kv_decode import (
    _kv_memory_t,
    _layer_step,
    _Prologue,
)
from deepsc_gan_tpu_torch.ops.masks import (
    create_look_ahead_mask,
    create_padding_mask,
)
from deepsc_gan_tpu_torch.ops.topk_kernel import (
    NEG,
    op_dtype,
    take_top,
    topk_logits,
)
from deepsc_gan_tpu_torch.train.steps import _final_wb
from deepsc_gan_tpu_torch.utils.config import Config


def _frozen_candidates(K: int, pad_idx: int, device=None):
    """The candidates a frozen beam proposes, the top K of a row that is 0
    at <PAD> and NEG elsewhere: (<PAD>, 0.0), then the K-1 lowest other ids
    at NEG. -> (vals (K,) f32, idx (K,) int32)."""
    vals = torch.full((K,), NEG, dtype=torch.float32, device=device)
    vals[0] = 0.0
    rest = torch.arange(1, K, device=device)
    rest = torch.where(rest - 1 < pad_idx, rest - 1, rest)
    idx = torch.cat([torch.tensor([pad_idx], device=device), rest])
    return vals, idx.to(torch.int32)


def _beam_select(h_flat, W, b, scores, finished, K: int, pad_idx: int,
                 end_idx: int, topk: Callable = topk_logits):
    """Stage 1: `topk` over the vocab projection of h_flat (B*K, D), per
    beam. Stage 2: the top K of the K*K candidates of each row. -> (src_beam
    (B, K), next_tok (B, K) int32, new scores (B, K), new finished (B, K)),
    the finished flags already following src_beam and OR-ed with the new
    <END> tokens."""
    B = scores.shape[0]
    vals, idx, lse = topk(h_flat, W, b, K)
    logp = (vals - lse[:, None]).reshape(B, K, K)
    idx = idx.reshape(B, K, K)
    fvals, fidx = _frozen_candidates(K, pad_idx, scores.device)
    frozen = finished[:, :, None]
    logp = torch.where(frozen, fvals, logp)
    idx = torch.where(frozen, fidx, idx)
    cand = (scores[:, :, None] + logp).reshape(B, K * K)
    pos = torch.arange(K * K, device=cand.device,
                       dtype=torch.int32).expand(B, K * K)
    top_scores, flat = take_top(cand, pos, K)
    flat = flat.long()
    src_beam = flat // K
    next_tok = idx.reshape(B, K * K).gather(1, flat)
    finished = finished.gather(1, src_beam) | (next_tok == end_idx)
    return src_beam, next_tok, top_scores, finished


class _Beams:
    """Tokens, scores and finished flags of B rows of K beams, only beam 0
    live at the start (identical prefixes must not multiply)."""

    def __init__(self, cfg: Config, B: int, K: int, device):
        T = cfg.max_length
        self.cfg, self.B, self.K = cfg, B, K
        self.tokens = torch.full((B, K, T + 1), cfg.pad_idx, dtype=torch.long,
                                 device=device)
        self.tokens[:, :, 0] = cfg.start_idx
        self.scores = torch.full((B, K), NEG, dtype=torch.float32,
                                 device=device)
        self.scores[:, 0] = 0.0
        self.finished = torch.zeros((B, K), dtype=torch.bool, device=device)

    def flat(self):
        return self.tokens.reshape(self.B * self.K, -1)

    def step(self, h_flat, W, b, i: int, topk: Callable):
        """Select from the hidden states of position i; -> the (B*K,) rows
        of the previous beams each new beam continues."""
        src, nxt, self.scores, self.finished = _beam_select(
            h_flat, W, b, self.scores, self.finished, self.K,
            self.cfg.pad_idx, self.cfg.end_idx, topk)
        self.tokens = self.tokens.gather(
            1, src[:, :, None].expand(-1, -1, self.tokens.shape[2]))
        self.tokens[:, :, i + 1] = nxt
        rows = torch.arange(self.B, device=src.device)[:, None] * self.K
        return (rows + src).reshape(-1)

    def best(self):
        """The best beam of each row (first maximum): (B, T+1) int32."""
        best = torch.argmax(self.scores, dim=1)
        rows = torch.arange(self.B, device=best.device)
        return self.tokens[rows, best].to(torch.int32)


def _vocab_table(model, dtype):
    """(W (V, D) in the scorer's operand dtype for `dtype` activations, b):
    cast once per decode call, not once per step."""
    W, b = _final_wb(model)
    return W.to(op_dtype(dtype)), b


def _full_loop(model, cfg: Config, K: int, topk: Callable) -> Callable:
    """The full-prefix beam: the whole decoder over the B*K buffers at
    every step."""
    T = cfg.max_length

    def loop(mem, enc_padding_mask):
        B, dev = mem.shape[0], mem.device
        mem_k = mem.repeat_interleave(K, dim=0)
        enc_mask_k = enc_padding_mask.repeat_interleave(K, dim=0)
        causal = create_look_ahead_mask(T + 1, dev)
        W, b = _vocab_table(model, mem.dtype)
        beams = _Beams(cfg, B, K, dev)
        for i in range(T):
            flat = beams.flat()
            combined = torch.maximum(create_padding_mask(flat, cfg.pad_idx),
                                     causal)
            h = model._semantic_decode(flat, mem_k, combined, enc_mask_k,
                                       apply_final=False)
            beams.step(h[:, i], W, b, i, topk)
        return beams.best()

    return loop


def _kv_loop(model, cfg: Config, K: int, topk: Callable) -> Callable:
    """The KV-cached beam: one position through the stack per step, the
    buffers reordered along the folded (B*K) axis to follow the surviving
    beams. The cross-attention memory is shared by a row's beams, not
    repeated K times."""

    def loop(mem, enc_padding_mask):
        pro = _Prologue(model, cfg, mem.device)
        B, dev = mem.shape[0], mem.device
        H, Dh = pro.heads, pro.depth
        mem = mem.to(pro.dtype)
        memKV = [_kv_memory_t(l.cross_mha, mem) for l in pro.dec.layers]
        cross_bias = (enc_padding_mask[:, :, 0, :] * NEG)[:, None]

        def x_attend(q, Km, Vm):
            """q (B*K, H, Dh); Km (B, H, Dh, Lm); Vm (B, H, Lm, Dh): the
            arithmetic of `_attend` with the beams a free axis."""
            lg = torch.einsum("bjhk,bhkl->bjhl", q.reshape(B, K, H, Dh),
                              Km).float()
            lg = lg / math.sqrt(Dh) + cross_bias
            w = torch.softmax(lg, dim=-1).to(Vm.dtype)
            return torch.einsum("bjhl,bhlk->bjhk", w, Vm).reshape(B * K, H,
                                                                  Dh)

        W, b = _vocab_table(model, pro.dtype)
        beams = _Beams(cfg, B, K, dev)
        caches = pro.buffers(B * K, dev)
        for i in range(pro.T):
            flat = beams.flat()
            x = pro.embed(flat[:, i], i)
            self_bias = pro.self_bias(flat, i, NEG)
            for layer, cache, (Km, Vm) in zip(pro.dec.layers, caches, memKV):
                x = _layer_step(layer, x, i, cache, self_bias,
                                lambda q: x_attend(q, Km, Vm), pro.dtype)
            src = beams.step(x, W, b, i, topk)
            caches = [(Kc.index_select(0, src), Vc.index_select(0, src))
                      for Kc, Vc in caches]
        return beams.best()

    return loop


def make_beam_decode(model, cfg: Config, beam_size: int = 4,
                     topk: Callable = topk_logits) -> Callable:
    """Full-prefix beam search at one noise level: `decode(inp, pnr_db,
    n_std, noise) -> (B, max_length+1) ids` (the best beam). `topk` scores
    the candidates (K6, or its plain version)."""
    return single_level(model, cfg, _full_loop(model, cfg, beam_size, topk))


def make_beam_decode_kv(model, cfg: Config, beam_size: int = 4,
                        topk: Callable = topk_logits) -> Callable:
    """KV-cached beam search at one noise level (the serving path), the
    same signature and ids as `make_beam_decode`."""
    return single_level(model, cfg, _kv_loop(model, cfg, beam_size, topk))


def make_beam_decode_sweep(model, cfg: Config, beam_size: int = 4,
                           topk: Callable = topk_logits) -> Callable:
    """KV-cached beam search across S noise levels in one call:
    `sweep(inp, pnr_db, n_stds[S], noise[S, B, L, channel_dim])
    -> (S, B, max_length+1) ids`."""
    return noise_sweep(model, cfg, _kv_loop(model, cfg, beam_size, topk))
