"""The port's fused beam-candidate scorer (`ops/topk_kernel.py`, K6's plain
version, which the wrapper runs on CPU tensors) and beam search's selection
against the JAX package on the CPU: `topk_logits` with the Pallas kernel
interpreted, `_take_top`, `_frozen_candidates` and `_beam_select`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.evaluate.beam import (
    _beam_select as jax_beam_select,
    _frozen_candidates as jax_frozen_candidates,
)
from deepsc_gan_tpu.ops.pallas.topk import (
    _take_top as jax_take_top,
    set_topk_kernel_mode,
    topk_logits as jax_topk_logits,
)
from deepsc_gan_tpu_torch.evaluate.beam import (
    _beam_select,
    _frozen_candidates,
)
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
from deepsc_gan_tpu_torch.ops import topk_kernel as topk

ATOL = 2e-5


@pytest.fixture
def interpret():
    set_topk_kernel_mode("interpret")
    yield
    set_topk_kernel_mode("auto")


def _case(n, d, v, seed=0):
    """h (N, D), W (D, V) in the JAX layout, b (V,), from numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (0.3 * rng.standard_normal((d, v))).astype(np.float32),
            (0.1 * rng.standard_normal(v)).astype(np.float32))


def _port(h, W, b, k, dtype=torch.float32):
    """The port's wrapper on CPU tensors, W in the port's (V, D) layout."""
    return [t.numpy() for t in topk.topk_logits(
        torch.from_numpy(h).to(dtype), torch.from_numpy(W.T.copy()).to(dtype),
        torch.from_numpy(b), k)]


@pytest.mark.parametrize("n,d,v,tn,tv", [
    (16, 8, 40, 8, 16),     # padding on both axes
    (24, 16, 64, 8, 32),    # exact tiles
    (10, 8, 50, 16, 32),    # n < tile
    (7, 8, 17, 8, 16),      # vocab < tile, odd sizes
])
@pytest.mark.parametrize("k", [1, 4])
def test_plain_version_matches_interpreted_tpu_kernel(interpret, n, d, v, tn,
                                                      tv, k):
    h, W, b = _case(n, d, v)
    want = [np.asarray(t) for t in jax_topk_logits(
        jnp.asarray(h), jnp.asarray(W), jnp.asarray(b), k, tn, tv)]
    topk.reset_launches()
    vals, idx, lse = _port(h, W, b, k)
    assert topk.launches == 0  # CPU tensors: the plain version
    assert vals.shape == (n, k) and vals.dtype == np.float32
    assert idx.dtype == np.int32 and lse.shape == (n,)
    np.testing.assert_array_equal(idx, want[1])
    np.testing.assert_allclose(vals, want[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse, want[2], atol=ATOL, rtol=0)


def test_ties_go_to_the_lowest_index_across_tiles(interpret):
    """Equal maxima in different vocab tiles of the TPU kernel (tiles of
    16): the lowest indices first, then the lowest index of the rest."""
    n, d, v, k = 4, 4, 32, 4
    h = np.ones((n, d), np.float32)
    W = np.zeros((d, v), np.float32)
    b = np.zeros(v, np.float32)
    b[[3, 19, 27]] = 1.0
    want = jax_topk_logits(jnp.asarray(h), jnp.asarray(W), jnp.asarray(b), k,
                           tn=8, tv=16)
    vals, idx, _ = _port(h, W, b, k)
    np.testing.assert_array_equal(idx, np.tile([3, 19, 27, 0], (n, 1)))
    np.testing.assert_array_equal(idx, np.asarray(want[1]))
    np.testing.assert_array_equal(vals, np.asarray(want[0]))


def test_bfloat16_operands_match_interpreted_tpu_kernel(interpret):
    """bf16 h and W (the serving path's operands): products of the rounded
    operands summed in f32 on both sides, so the same indices."""
    h, W, b = _case(16, 8, 64, seed=5)
    want = jax_topk_logits(jnp.asarray(h, jnp.bfloat16),
                           jnp.asarray(W, jnp.bfloat16), jnp.asarray(b), 4,
                           tn=8, tv=32)
    vals, idx, lse = _port(h, W, b, 4, torch.bfloat16)
    np.testing.assert_array_equal(idx, np.asarray(want[1]))
    np.testing.assert_allclose(vals, np.asarray(want[0]), atol=ATOL)
    np.testing.assert_allclose(lse, np.asarray(want[2]), atol=ATOL)


@pytest.mark.parametrize("k", [1, 3, 6])
def test_take_top_matches_jax(k):
    """Values with many exact ties (integers 0..4) and NEG entries."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 5, (6, 9)).astype(np.float32)
    x[0, :] = topk.NEG
    x[1, 4:] = topk.NEG
    cols = np.broadcast_to(np.arange(9, dtype=np.int32), x.shape)
    want = jax_take_top(jnp.asarray(x), jnp.asarray(cols), k)
    got = topk.take_top(torch.from_numpy(x), torch.from_numpy(cols.copy()),
                        k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("k", [9, 16, 64])
def test_take_top_past_eight_matches_jax(k):
    """The selection past k = 8 (what the wide K6 kernels compute on the
    card, `_take_top` in the JAX kernel): exact ties and NEG entries over
    70 columns."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 7, (5, 70)).astype(np.float32)
    x[1, 50:] = topk.NEG
    cols = np.broadcast_to(np.arange(70, dtype=np.int32), x.shape)
    want = jax_take_top(jnp.asarray(x), jnp.asarray(cols), k)
    got = topk.take_top(torch.from_numpy(x), torch.from_numpy(cols.copy()),
                        k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert topk.is_wide(128, k) and not topk.is_wide(128, 8)


@pytest.mark.parametrize("K", [1, 2, 4, 5])
@pytest.mark.parametrize("pad_idx", [0, 2])
def test_frozen_candidates_match_jax(K, pad_idx):
    want = jax_frozen_candidates(K, pad_idx)
    got = _frozen_candidates(K, pad_idx)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("K", [1, 4])
def test_beam_select_matches_jax(K):
    """One selection step with some beams finished (and beams still at
    NEG, as at step 0): the same source beams, tokens and finished flags,
    the scores within 2e-5. W goes to JAX as (D, V), to the port as
    (V, D)."""
    B, D, V, pad, end = 3, 8, 30, 0, 2
    rng = np.random.default_rng(K)
    h = rng.standard_normal((B * K, D)).astype(np.float32)
    W = rng.standard_normal((D, V)).astype(np.float32)
    b = (0.1 * rng.standard_normal(V)).astype(np.float32)
    scores = (-rng.random((B, K)) * 5).astype(np.float32)
    finished = rng.random((B, K)) < 0.4
    if K > 1:
        scores[0, 1:] = topk.NEG
        finished[0] = False
        finished[1, 0] = True
    want = jax_beam_select(jnp.asarray(h), jnp.asarray(W), jnp.asarray(b),
                           jnp.asarray(scores), jnp.asarray(finished), K, pad,
                           end)
    got = _beam_select(torch.from_numpy(h), torch.from_numpy(W.T.copy()),
                       torch.from_numpy(b), torch.from_numpy(scores),
                       torch.from_numpy(finished), K, pad, end)
    for name, g, w in zip(("src_beam", "next_tok", "finished"),
                          (got[0], got[1], got[3]),
                          (want[0], want[1], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("vocab_rows", [64, 128])
def test_vocab_splits_cover_every_vocab_tile_once(vocab_rows):
    """K6's vocab splits (`ce.vocab_splits` at the tiles its library
    reports: 64 rows of h, 64 vocab rows in f32 and 128 in bf16), cut as
    csrc/topk.cu cuts them (split s owns tiles [s t, min((s + 1) t, T)),
    t = ceil(T / splits)): over a grid of N, V and blocks per SM, every
    vocab tile lies in exactly one split and no split is empty. At the
    beam's shapes on 132 SMs with two blocks per SM: 58 splits at N = 256,
    3 at N = 4,864 (tiles of 128)."""
    for n in (1, 7, 64, 100, 256, 1984, 4864, 100000):
        for v in (1, 17, 127, 128, 129, 1000, 22234):
            for blocks in (1, 2, 3, 4):
                for sms in (1, 132):
                    splits = ce.vocab_splits(n, v, sms, 64, vocab_rows,
                                             blocks)
                    tiles = -(-v // vocab_rows)
                    per = -(-tiles // splits)
                    owned = [range(s * per, min((s + 1) * per, tiles))
                             for s in range(splits)]
                    assert all(len(r) > 0 for r in owned)
                    assert [t for r in owned for t in r] == \
                        list(range(tiles))
    if vocab_rows == 128:
        assert ce.vocab_splits(256, 22234, 132, 64, 128, 2) == 58
        assert ce.vocab_splits(4864, 22234, 132, 64, 128, 2) == 3
