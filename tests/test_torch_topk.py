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


@pytest.mark.parametrize("k", [9, 16])
def test_plain_version_past_eight_matches_interpreted_tpu_kernel(interpret,
                                                                  k):
    """The plain K6 at the lists the tensor-core wide kernel keeps on the
    card (k = 9: the widened decoder's beam; 16) and the widened decoder's
    D = 200, against the TPU kernel under the Pallas interpreter (vocab
    tiles of 128, the last ragged)."""
    n, d, v = 24, 200, 300
    h, W, b = _case(n, d, v, seed=k)
    want = [np.asarray(t) for t in jax_topk_logits(
        jnp.asarray(h), jnp.asarray(W), jnp.asarray(b), k, 8, 128)]
    vals, idx, lse = _port(h, W, b, k)
    np.testing.assert_array_equal(idx, want[1])
    np.testing.assert_allclose(vals, want[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse, want[2], atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [65, 100])
def test_plain_version_past_the_list_matches_interpreted_tpu_kernel(
        interpret, k):
    """The plain K6 past k = 64, where the tensor-core wide kernel's long
    path takes bf16 on the card (lists of 16 a split, a per-row bound from
    their union, an emission of the keys at or above it, a radix select;
    k = 100: `--beam-size 100`), against the TPU kernel under the Pallas
    interpreter at N = 24, D = 200 and V = 384 (three vocab tiles of
    128)."""
    n, d, v = 24, 200, 384
    h, W, b = _case(n, d, v, seed=k)
    want = [np.asarray(t) for t in jax_topk_logits(
        jnp.asarray(h), jnp.asarray(W), jnp.asarray(b), k, 8, 128)]
    vals, idx, lse = _port(h, W, b, k)
    np.testing.assert_array_equal(idx, want[1])
    np.testing.assert_allclose(vals, want[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse, want[2], atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [257, 264])
def test_plain_version_past_256_matches_interpreted_tpu_kernel(interpret, k):
    """The plain K6 past k = 256 and at k = V, where the select kernels
    take every call on the card (a radix select of each row's k best keys,
    then a sort of them), against the TPU kernel under the Pallas
    interpreter at N = 8, D = 200 and V = 264 (three vocab tiles of 128,
    the last ragged; k = V: every logit of a row, in order)."""
    n, d, v = 8, 200, 264
    h, W, b = _case(n, d, v, seed=k)
    want = [np.asarray(t) for t in jax_topk_logits(
        jnp.asarray(h), jnp.asarray(W), jnp.asarray(b), k, 8, 128)]
    vals, idx, lse = _port(h, W, b, k)
    np.testing.assert_array_equal(idx, want[1])
    np.testing.assert_allclose(vals, want[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse, want[2], atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [100, 256])
def test_take_top_long_lists_match_jax(k):
    """`take_top` at the long lists (k = 100 and 256), over rows with
    many equal values and with every value below 0, against the JAX
    package's `_take_top`: the same values and indices, ties to the
    lowest index."""
    rng = np.random.default_rng(k)
    x = rng.integers(-9, 9, (6, 700)).astype(np.float32)
    x[3] = -rng.integers(1, 5, 700).astype(np.float32)
    cols = np.broadcast_to(np.arange(700, dtype=np.int32), x.shape).copy()
    got = topk.take_top(torch.from_numpy(x), torch.from_numpy(cols), k)
    want = jax_take_top(jnp.asarray(x), jnp.asarray(cols), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


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


@pytest.mark.parametrize("dtype,d,k,tensor_core", [
    (torch.bfloat16, 200, 9, True), (torch.bfloat16, 200, 16, True),
    (torch.bfloat16, 200, 64, True), (torch.bfloat16, 512, 9, True),
    (torch.bfloat16, 512, 16, True), (torch.bfloat16, 512, 64, True),
    (torch.bfloat16, 512, 4, True), (torch.bfloat16, 25, 1, True),
    (torch.bfloat16, 128, 9, True), (torch.bfloat16, 200, 4, False),
    (torch.bfloat16, 128, 8, False), (torch.bfloat16, 200, 65, True),
    (torch.bfloat16, 512, 100, True), (torch.bfloat16, 128, 100, True),
    (torch.bfloat16, 200, 256, True), (torch.bfloat16, 512, 256, True),
    (torch.bfloat16, 200, 257, False), (torch.bfloat16, 128, 1000, False),
    (torch.float32, 200, 9, False), (torch.float32, 512, 64, False),
    (torch.float32, 128, 4, False), (torch.float32, 128, 100, False),
    (torch.float32, 200, 256, False)])
def test_tensor_core_wide_routing(dtype, d, k, tensor_core):
    """bf16 calls the tuned K6 does not take (k past 8, D past 256 or off
    8 columns) run the tensor-core wide kernel at V = 22,234 up to
    k = K_LIST = 256 (past k = 64 its long path: lists of 16, a per-row
    bound, an emission of the keys at or above it, a radix select); the
    tuned shapes stay on the tuned kernel, f32 and longer lists on the
    select kernels (csrc/topk_select.cu)."""
    assert topk.uses_tensor_core(dtype, d, k, 22234) == tensor_core
    assert topk.is_wide(d, k) or not tensor_core


# the card's shared memory an SM and a block can use, and what each block
# sets aside (H100: 228 KB an SM, 227 KB a block)
SM_SMEM, BLOCK_SMEM, RESERVED = 233472, 232448, 1024


@pytest.mark.parametrize("k,length,blocks", [
    (1, 16, 3), (9, 16, 3), (16, 16, 3), (17, 32, 2), (32, 32, 2),
    (33, 64, 2), (64, 64, 2), (65, 16, 3), (100, 16, 3), (256, 16, 3)])
def test_wide_mma_plan_fits_the_card(k, length, blocks):
    """The tensor-core wide K6's shared memory (`wide_mma_plan`, the
    library's own plan on the card: held to it by a card test) fits a
    block of the H100, and lets as many blocks share an SM as the design
    counts on: three with lists of 16 (the long path's past k = 64 too),
    two with longer ones (registers may allow fewer: the card test reads
    the occupancy calculator); past K_LIST no plan."""
    plan = topk.wide_mma_plan(k)
    assert plan.list_length == length and plan.stages == topk.MMA_STAGES
    assert plan.smem <= BLOCK_SMEM
    assert SM_SMEM // (plan.smem + RESERVED) == blocks
    assert topk.wide_mma_plan(topk.K_LIST + 1) is None
    assert topk.wide_mma_plan(0) is None


def _split_tiles(v, splits):
    """Vocab tiles a split owns as the library cuts them
    (`ceo::split_tiles`), or -1 where a split would own none, a count the
    library refuses."""
    tiles = -(-v // topk.MMA_TILE)
    per = -(-tiles // splits)
    return -1 if (splits - 1) * per >= tiles else per


@pytest.mark.parametrize("k", [65, 100, 121, 128, 200, 256])
@pytest.mark.parametrize("n", [1, 64, 256, 768, 1024, 6400, 16384])
def test_long_plan(k, n):
    """The long path's plan at V = 22,234 on 132 SMs (the partial kernel
    at three blocks an SM with lists of 16, the emission at four): every
    partial and emission split owns a vocab tile (a count the library
    takes) and all but the last fill their lists with 2 k keys between
    them, within the threshold's shared memory; a row's candidate slots
    hold at least 2 k keys, at most CAND_CAP, and all rows' at most
    CAND_BUDGET bytes where 2 k allows."""
    v = 22234
    plan = topk.long_plan(n, v, k, 132, (64, topk.MMA_TILE, 3),
                          (64, topk.MMA_TILE, 4))
    tiles = -(-v // topk.MMA_TILE)
    assert topk.takes_long(k, v)
    assert 1 <= plan.splits <= tiles and 1 <= plan.emit_splits <= tiles
    assert _split_tiles(v, plan.splits) > 0
    assert _split_tiles(v, plan.emit_splits) > 0
    assert (plan.splits - 1) * topk.SELECT_LIST >= 2 * k
    assert 8 * plan.splits * topk.SELECT_LIST <= topk.MERGE_SMEM
    assert 2 * k <= plan.cap <= topk.CAND_CAP
    assert 8 * n * plan.cap <= max(topk.CAND_BUDGET, 8 * n * 2 * k)


@pytest.mark.parametrize("v", [1800, 5000, 22234, 25000])
def test_long_plan_takes_every_k(v):
    """At every k the long path takes over V (65..256 where `takes_long`
    holds), every row count from one row to the beam-256 call's 64 x 256
    and 114 to 132 SMs: the partial kernel's splits are a count the
    library takes (each owning a vocab tile) with 2 k keys in the lists of
    all but the last, and the emission's splits own a tile each."""
    for k in range(topk.K_SHORT + 1, topk.K_LIST + 1):
        if not topk.takes_long(k, v):
            continue
        for n in (1, 100, 256, 700, 1000, 3000, 6400, 16384):
            for sms in (114, 132):
                plan = topk.long_plan(n, v, k, sms, (64, topk.MMA_TILE, 3),
                                      (64, topk.MMA_TILE, 4))
                assert _split_tiles(v, plan.splits) > 0, (k, n, sms)
                assert _split_tiles(v, plan.emit_splits) > 0, (k, n, sms)
                assert (plan.splits - 1) * topk.SELECT_LIST >= 2 * k, \
                    (k, n, sms)


@pytest.mark.parametrize("k,v,takes", [(65, 22234, True), (256, 22234, True),
                                       (256, 25000, True), (256, 25001, False),
                                       (100, 1000, False), (100, 1800, True),
                                       (64, 100, True)])
def test_long_path_routing_by_vocab(k, v, takes):
    """Past k = 64 the bf16 K6 takes the long path only where the vocab
    fits its fallback's shared memory (V up to LONG_MAX_V) and has tiles
    enough for lists of 16 holding 2 k keys; elsewhere the select kernels
    (csrc/topk_select.cu).
    Up to k = 64 the vocab does not enter."""
    assert topk.uses_tensor_core(torch.bfloat16, 200, k, v) == takes
    assert topk.uses_long_list(torch.bfloat16, 200, k, v) == (takes
                                                             and k > 64)


@pytest.mark.parametrize("dtype,d,k,v,select", [
    (torch.float32, 200, 9, 22234, True), (torch.float32, 128, 9, 22234, True),
    (torch.float32, 512, 4, 22234, True), (torch.float32, 25, 1, 22234, True),
    (torch.float32, 200, 1000, 22234, True),
    (torch.float32, 128, 22234, 22234, True),
    (torch.float32, 128, 4, 22234, False),
    (torch.float32, 128, 8, 32000, False),
    (torch.bfloat16, 200, 9, 22234, False),
    (torch.bfloat16, 200, 256, 22234, False),
    (torch.bfloat16, 200, 257, 22234, True),
    (torch.bfloat16, 128, 1000, 22234, True),
    (torch.bfloat16, 128, 22234, 22234, True),
    (torch.bfloat16, 128, 100, 32000, True),
    (torch.bfloat16, 128, 65, 25001, True),
    (torch.bfloat16, 128, 65, 25000, False),
    (torch.bfloat16, 128, 64, 32000, False),
    (torch.bfloat16, 25, 300, 1000, True),
    (torch.bfloat16, 128, 8, 32000, False)])
def test_select_routing(dtype, d, k, v, select):
    """The select kernels (csrc/topk_select.cu) take every call of the
    wide kernels that the bf16 tensor-core wide kernel does not: every f32
    one (k past 8, D past 256 or off 8 columns, up to k = V), and bf16 past
    k = 256, or past k = 64 where the long path does not take V (past
    25,000); the tuned shapes stay on the tuned kernel in both dtypes."""
    assert topk.uses_select(dtype, d, k, v) == select
    assert not (select and topk.uses_tensor_core(dtype, d, k, v))
    assert select == (topk.is_wide(d, k)
                      and not topk.uses_tensor_core(dtype, d, k, v))


@pytest.mark.parametrize("k,spill", [(1, False), (22234, False),
                                     (24704, False), (24705, True)])
def test_select_keys_spill_past_shared_memory(k, spill):
    """A row's k keys (8 bytes each) stay in the select block's shared
    memory of the H100 (227 KB a block, SELECT_RESERVED of it taken by the
    candidate buffer and the static part) up to k = 24,704, past it in the
    caller's scratch."""
    assert topk.select_keys_spill(k, 232448) == spill


TILE_V, BUF = 128, topk.MMA_BUF


def _key(x, col):
    """The kernel's order as a sort key: larger value first, then the
    lower index (-0.0 as +0.0)."""
    return (-(float(x) + 0.0), col)


def _merge_rank(lst, buf, k):
    """The merge by rank: each key's place among list and buffer; the
    first k kept (the keys are unique: their indices are)."""
    return sorted(lst + buf)[:k]


BISECT = 12


def _bound(vals, k):
    """The kernel's first-tile bound, in f32: the quad's finite range of
    the tile's logits halved BISECT times, keeping a low end that at least
    k of them reach; -inf where fewer than k are finite."""
    finite = vals[vals > -np.inf].astype(np.float32)
    if len(finite) < k:
        return -np.inf
    lo, hi = finite.min(), finite.max()
    for _ in range(BISECT):
        mid = np.float32(lo + np.float32(0.5) * (hi - lo))
        if (vals >= mid).sum() >= k:
            lo = mid
        else:
            hi = mid
    return lo


def _emulate_split(x, c0, c1, k, shared):
    """csrc/topk_wide_mma.cu's selection over columns [c0, c1) of the
    logits x (rows, V) of one row tile, tile by tile in the kernel's order:
    a quad's thread t holds columns 8 q + 2 t + e of each 128-column tile;
    the threshold, the larger of the list's k-th key (none until it holds
    k) and the row's shared one (`shared`, read before each tile, raised
    by every full list: here the splits run one after another, one of the
    orders the blocks may take); while the list is not full, the bound (a
    value at least k logits of the tile reach, BISECT halvings of their
    range); candidates above the threshold's value (or equal to it, where
    its index is not below the tile) and at the bound, written thread
    after thread, BUF a round, merged by rank, the rest kept while their
    key is above the raised threshold. -> per row, its list (k keys at
    most)."""
    order = [8 * q + 2 * t + e for t in range(4) for q in range(16)
             for e in range(2)]
    out = []
    for r, row in enumerate(x):
        lst = []
        for t0 in range(c0, c1, TILE_V):
            cols = np.arange(t0, t0 + TILE_V)
            vals = np.where(cols < c1, row[np.minimum(cols, len(row) - 1)],
                            -np.inf)
            seen = shared[r]
            thr = min(lst[k - 1], seen) if len(lst) == k else seen
            lo = -np.inf
            if len(lst) < k:
                lo = _bound(vals, k)
            tv, ties = -np.inf, False
            if thr != NONE:
                tv, ties = -thr[0], thr[1] >= t0
            cand = [c for c in order
                    if (vals[c] > tv or (ties and vals[c] == tv))
                    and vals[c] >= lo]
            while cand:
                take, cand = cand[:BUF], cand[BUF:]
                lst = _merge_rank(lst, [_key(vals[c], t0 + c)
                                        for c in take], k)
                if len(lst) == k:
                    shared[r] = min(shared[r], lst[k - 1])
                    thr = min(lst[k - 1], seen)
                    cand = [c for c in cand if _key(vals[c], t0 + c) < thr]
        out.append(lst)
    return out


NONE = (np.inf, -1)  # below every key in this order: no threshold yet
MAX_CAND = 512


def _emulate(x, k, splits, reverse=False):
    """Every split's lists (vocab tiles of 128 cut as the wrapper cuts
    them; `reverse`: the splits run last to first), then the merge kernel:
    the keys at or above the row's shared threshold ranked among
    themselves where at most MAX_CAND, else k rounds of the largest head
    key over the splits' lists. -> (vals, idx) as numpy arrays."""
    v = x.shape[1]
    tiles = -(-v // TILE_V)
    per = -(-tiles // splits)
    shared = [NONE] * x.shape[0]
    ran = [s for s in range(splits) if s * per < tiles]
    lists = [_emulate_split(x, s * per * TILE_V, min((s + 1) * per * TILE_V,
                                                     v), k, shared)
             for s in (ran[::-1] if reverse else ran)]
    vals, idx = [], []
    for r in range(x.shape[0]):
        cand = [key for ls in lists for key in ls[r] if key <= shared[r]]
        if shared[r] != NONE and len(cand) <= MAX_CAND:
            best = sorted(cand)[:k]
        else:
            heads = [list(ls[r]) for ls in lists]
            best = []
            for _ in range(k):
                s = min((h[0], i) for i, h in enumerate(heads) if h)[1]
                best.append(heads[s].pop(0))
        vals.append([-key[0] for key in best])
        idx.append([key[1] for key in best])
    return np.array(vals, np.float32), np.array(idx, np.int32)


def _tie_logits(seed, rows, v, mode):
    """Logits with planted ties: "dyadic", integers 0..6 (equal values in
    one tile, across tiles and across splits); "flat", every logit 0 but a
    few 1s (a tile's 128 columns all candidates: the buffer's rounds);
    "spread", distinct values with the largest equal ones placed in
    different tiles and splits; "falling", values falling with the index
    (the k best all in the first tile: the bound alone decides what enters
    it), pairs of equal values in row 1; "rising", values rising with the
    index (every tile beats the list: a merge each tile); "negative",
    integers -1..-6 (every value below 0, many equal)."""
    rng = np.random.default_rng(seed)
    if mode in ("falling", "rising"):
        x = np.tile(np.arange(v, dtype=np.float32), (rows, 1))
        x[1] = np.floor(x[1] / 2)
        return -x if mode == "falling" else x
    if mode == "dyadic":
        return rng.integers(0, 7, (rows, v)).astype(np.float32)
    if mode == "negative":
        return -rng.integers(1, 7, (rows, v)).astype(np.float32)
    if mode == "flat":
        x = np.zeros((rows, v), np.float32)
        x[:, [3, 129, 130, 500, v - 1]] = 1.0
        x[1, :] = -0.0  # -0 ties with +0
        return x
    x = rng.standard_normal((rows, v)).astype(np.float32)
    x[:, [5, 6, 140, 400, 401, 777, v - 2]] = 9.0
    return x


@pytest.mark.parametrize("k", [9, 16, 64])
@pytest.mark.parametrize("mode", ["dyadic", "flat", "spread", "falling",
                                  "rising"])
def test_threshold_filter_emulation_equals_take_top(k, mode):
    """A pure-torch/numpy emulation of the tensor-core wide K6's selection
    (the threshold filter, the buffer's rounds, the merge by rank and the
    split merge), fed tile by tile in the kernel's column order, equals
    `take_top` and the JAX `_take_top` over the whole row: indices and
    values, at k = 9, 16 and 64 with ties planted inside one tile, across
    tiles and across splits (V = 1,000: eight tiles, the last ragged, in
    three splits)."""
    rows, v, splits = 4, 1000, 3
    x = _tie_logits(k, rows, v, mode)
    got = _emulate(x, k, splits)
    # the splits in the other order (the last first): other lists, the
    # same k best
    rev = _emulate(x, k, splits, reverse=True)
    np.testing.assert_array_equal(rev[1], got[1])
    np.testing.assert_array_equal(rev[0], got[0])
    cols = np.broadcast_to(np.arange(v, dtype=np.int32), x.shape)
    want = topk.take_top(torch.from_numpy(x), torch.from_numpy(cols.copy()),
                         k)
    jax_want = jax_take_top(jnp.asarray(x), jnp.asarray(cols), k)
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], np.asarray(jax_want[1]))
    np.testing.assert_array_equal(got[0], np.asarray(jax_want[0]))


def _key_bits(x, col):
    """The kernel's 64-bit key of an f32 value at a vocab column: the
    value's order-preserving bits (-0 as +0), then the complement of the
    column."""
    u = int(np.float32(np.float32(x) + np.float32(0.0)).view(np.uint32))
    u ^= 0xFFFFFFFF if u & 0x80000000 else 0x80000000
    return (u << 32) | (0xFFFFFFFF - col)


def _radix_bound(keys, k):
    """The kernel's radix select (`radix_bound`): a byte a pass from the
    top, the wanted rank's byte picked from the counts of the keys matching
    the bytes so far, stopping where every key of the byte is wanted. Zero
    keys (a short list's padding) are never counted. -> (prefix, mask):
    the keys with key & mask >= prefix are the k best."""
    prefix, mask, want = 0, 0, k
    for shift in range(56, -1, -8):
        hist = [0] * 256
        for key in keys:
            if key and key & mask == prefix:
                hist[(key >> shift) & 0xFF] += 1
        above = 0
        for byte in range(255, -1, -1):
            if above + hist[byte] >= want:
                break
            above += hist[byte]
        prefix |= byte << shift
        mask |= 0xFF << shift
        want -= above
        if hist[byte] == want:
            break
    return prefix, mask


def _radix_top(keys, k):
    """The kernel's select (`select_top`): the keys `_radix_bound` singles
    out, each placed by its rank. -> the k best, largest first."""
    prefix, mask = _radix_bound(keys, k)
    best = [key for key in keys if key and key & mask >= prefix]
    assert len(best) == k
    return sorted(best, reverse=True)


@pytest.mark.parametrize("mode", ["flat", "dyadic", "negative", "spread",
                                  "rising"])
@pytest.mark.parametrize("k", [1, 9, 64, 100, 256])
def test_split_merge_radix_select_equals_sorting(mode, k):
    """The long path's radix select (its threshold over the splits'
    lists, each sorted, a short one padded with zeros; its final select
    over a row's candidates) keeps the same k keys as sorting their union,
    in the same order: with ties on every value byte (flat: the select goes
    down to the index bytes), integer ties, every value below 0, spread
    values, and splits shorter than k."""
    for x in _tie_logits(k + 7, 2, 1000, mode):
        keys = [_key_bits(v, c) for c, v in enumerate(x)]
        lists = []
        for s0 in range(0, 1000, 300):  # splits of 300, the last of 100
            part = sorted(keys[s0:s0 + 300], reverse=True)[:k]
            lists += part + [0] * (k - len(part))
        assert _radix_top(lists, k) == sorted(keys, reverse=True)[:k]


def _emulate_long(x, k, splits, cap):
    """The long path (csrc/topk_wide_mma.cu past k = 64) on one row of
    logits x: each vocab split's own 16 best keys (the partial kernel with
    lists of 16 and no shared threshold), the bound of their union's k
    best (`_radix_bound`), the row's keys at or above it (the emission),
    and their k best (`_radix_top`; where more than `cap` keys pass, the
    fallback's select over every key of the row). -> (the k best, the
    candidates' count)."""
    keys = [_key_bits(v, c) for c, v in enumerate(x)]
    tiles = -(-len(keys) // TILE_V)
    per = -(-tiles // splits)
    union = []
    for s0 in range(0, len(keys), per * TILE_V):
        part = sorted(keys[s0:s0 + per * TILE_V], reverse=True)[:16]
        union += part + [0] * (16 - len(part))
    prefix, mask = _radix_bound(union, k)
    cand = [key for key in keys if key & mask >= prefix]
    best = _radix_top(cand if len(cand) <= cap else keys, k)
    return best, len(cand)


@pytest.mark.parametrize("k", [65, 100, 256])
@pytest.mark.parametrize("mode", ["flat", "dyadic", "negative", "spread",
                                  "falling", "rising"])
def test_long_path_emulation_equals_take_top(k, mode):
    """The long path's selection, emulated (`_emulate_long`: lists of 16 a
    split, the union's bound, the keys at or above it, their k best, or the
    fallback's where they overflow the candidate slots), equals `take_top`
    and the JAX `_take_top`: indices and values at k = 65, 100 and 256 over
    V = 6,000 in as many splits as the long path's plan takes (8 vocab
    tiles of 128 a split, or enough for 2 k keys in their lists of 16),
    with equal values (flat: most rows' keys
    differ only by index), integer ties, every value below 0, spread
    values, and the k best all in the first split (falling) or the last
    (rising). Every key of the k best reaches the bound; where the values
    are spread, few more than k do."""
    rows, v = 2, 6000
    tiles = -(-v // TILE_V)
    splits = min(max(6, -(-2 * k // 16) + 1), tiles)
    x = _tie_logits(k + 3, rows, v, mode)
    cols = np.broadcast_to(np.arange(v, dtype=np.int32), x.shape)
    want = topk.take_top(torch.from_numpy(x), torch.from_numpy(cols.copy()),
                         k)
    jax_want = jax_take_top(jnp.asarray(x), jnp.asarray(cols), k)
    for r in range(rows):
        best, count = _emulate_long(x[r], k, splits, 4 * k)
        idx = [0xFFFFFFFF - (key & 0xFFFFFFFF) for key in best]
        np.testing.assert_array_equal(idx, want[1][r].numpy())
        np.testing.assert_array_equal(idx, np.asarray(jax_want[1][r]))
        assert count >= k
        if mode == "spread":
            assert count <= k + 200


def _select_bound(keys, v, k):
    """The select kernel's radix select (csrc/topk_select.cu
    `radix_bound`): a byte a pass from the top, the index's bytes that
    V - 1 does not reach skipped (the same in every key), the wanted
    rank's byte picked from the counts of the keys matching the bytes so
    far, stopping where every key of the byte is wanted. -> (prefix,
    mask): the keys with key & mask >= prefix are the k best."""
    prefix, mask, want = 0, 0, k
    for shift in range(56, -1, -8):
        if 0 < shift < 32 and (v - 1) >> shift == 0:
            continue
        hist = [0] * 256
        for key in keys:
            if key & mask == prefix:
                hist[(key >> shift) & 0xFF] += 1
        above = 0
        for byte in range(255, -1, -1):
            if above + hist[byte] >= want:
                break
            above += hist[byte]
        prefix |= byte << shift
        mask |= 0xFF << shift
        want -= above
        if hist[byte] == want:
            break
    return prefix, mask


def _select_sort(keys):
    """The select kernel's sort (`sort_desc`): a bitonic network over the
    next power of two p >= k whose merges all sort the same way (a flip,
    then half-cleaners), the comparators past k left out (the kernel runs
    the steps within groups of 32 places in a warp's registers, where the
    places past k hold zeros, below every key: the same exchanges)."""
    keys, k = list(keys), len(keys)
    p = 1
    while p < k:
        p <<= 1
    size = 2
    while size <= p:
        stride = size >> 1
        while stride:
            for i in range(p // 2):
                blk, pos = divmod(i, stride)
                if stride == size >> 1:
                    a, b = blk * size + pos, blk * size + size - 1 - pos
                else:
                    a = blk * 2 * stride + pos
                    b = a + stride
                if b < k and keys[a] < keys[b]:
                    keys[a], keys[b] = keys[b], keys[a]
            stride >>= 1
        size <<= 1
    return keys


@pytest.mark.parametrize("k", [1, 9, 257, 1000, 1500])
@pytest.mark.parametrize("mode", ["flat", "dyadic", "negative", "spread",
                                  "falling"])
def test_select_emulation_equals_take_top(mode, k):
    """The select kernels' selection, emulated on a row of logits (each
    logit's 64-bit key, `_select_bound`'s radix passes, the keys at or
    above the bound gathered in a scrambled order, as the kernel's atomics
    may, and `_select_sort`), equals `take_top` (and the JAX `_take_top`
    up to k = 257): indices and values at k = 1, 9, 257, 1,000 and V =
    1,500 (a full sort), with equal values (flat: -0.0 and +0.0 in row 1,
    the keys of a row differing by index alone), integer ties, every value
    below 0, spread values and values falling with the index."""
    rows, v = 2, 1500
    x = _tie_logits(k + 11, rows, v, mode)
    cols = np.broadcast_to(np.arange(v, dtype=np.int32), x.shape)
    want = topk.take_top(torch.from_numpy(x), torch.from_numpy(cols.copy()),
                         k)
    jax_want = (jax_take_top(jnp.asarray(x), jnp.asarray(cols), k)
                if k <= 257 else None)
    rng = np.random.default_rng(k)
    for r in range(rows):
        keys = [_key_bits(val, c) for c, val in enumerate(x[r])]
        prefix, mask = _select_bound(keys, v, k)
        best = [key for key in keys if key & mask >= prefix]
        assert len(best) == k
        best = _select_sort([best[i] for i in rng.permutation(k)])
        idx = [0xFFFFFFFF - (key & 0xFFFFFFFF) for key in best]
        np.testing.assert_array_equal(idx, want[1][r].numpy())
        np.testing.assert_array_equal(x[r][idx], want[0][r].numpy())
        if jax_want is not None:
            np.testing.assert_array_equal(idx, np.asarray(jax_want[1][r]))


def _fma(a, b, c):
    """f32 fmaf(a, b, c), emulated: the exact product and sum in f64 (a
    product of two f32 values is exact there), rounded once to f32."""
    return (a.double() * b.double() + c.double()).float()


def _mode_case(n, d, v, mode, seed):
    """h (N, D), W (D, V) in the JAX layout and b (V,) as chip_smoke.py's K6
    rows make them: "dyadic", exact logits with many ties (h and W
    integers over 64 and 16, b over 64); "tie", every logit its bias, 1 at
    a few indices in different vocab tiles and splits, 0 elsewhere;
    "negative", the dyadic logits less 3 (every one below 0)."""
    rng = np.random.default_rng(seed)
    if mode == "tie":
        b = np.zeros(v, np.float32)
        b[[v - 3, 7, v // 2, 130, 64]] = 1.0
        return (np.ones((n, d), np.float32), np.zeros((d, v), np.float32),
                b)
    h = (rng.integers(-8, 9, (n, d)) / 64).astype(np.float32)
    W = (rng.integers(-2, 3, (d, v)) / 16).astype(np.float32)
    b = (rng.integers(-8, 9, v) / 64).astype(np.float32)
    if mode == "negative":
        b -= 3.0
        assert (h @ W + b).max() < 0
    return h, W, b


def _merge_top(vals, idx, length):
    """The best `length` of candidate lists (..., m), ordered by value
    descending then index ascending: what merging them by insertion gives
    whatever the order (the order is total and every index distinct)."""
    order = np.lexsort((idx, -vals), axis=-1)[..., :length]
    return (np.take_along_axis(vals, order, -1),
            np.take_along_axis(idx, order, -1))


def _merge_ms(m, s, m2, s2):
    """`merge_ms` of csrc/topk.cu: (max, sum of exp(x - max)) pairs."""
    mm = np.maximum(m, m2)
    return mm, s * np.exp(m - mm) + s2 * np.exp(m2 - mm)


def _tiled_topk(h, W, b, k, splits):
    """The f32 K6 on the 128 x 128 tile in its order (csrc/topk.cu
    `topk_tiled_kernel`, then `topk_combine_kernel`) on f32 CPU tensors:
    each logit a sum over d in order 0..D-1 by fmaf, then the bias added;
    per split (`split_tiles`: ceil(tiles / splits) tiles each) and vocab
    tile of 128 in order, the 16 threads tx of a row each take the max of
    their 8 columns (4 tx + j, 64 + 4 tx + j, j < 4) and the half-warp the
    max of theirs; each thread sums the exponentials of its columns less
    the new max in column order, the half-warp adds the 16 sums by xor
    shuffles (1, 2, 4, 8), and the row's running sum is rescaled to the
    new max; each thread keeps a list of L (the smallest of 1, 2, 4, 8
    holding k), a logit entering only if it is above the list's last entry
    (its columns come in increasing order); the 16 lists merged once per
    split (a butterfly of merges of two sorted
    lists); then a warp a row merges the splits (lane l splits l, l + 32,
    ..., in order, then a butterfly over the lanes), lse = m + log(s).
    -> (vals (N, k), idx (N, k) int32, lse (N,)) as numpy."""
    n, d = h.shape
    v = W.shape[0]
    acc = torch.zeros((n, v))
    for kk in range(d):
        acc = _fma(h[:, kk, None], W[None, :, kk], acc)
    x = (acc + b).numpy()
    length = next(m for m in (1, 2, 4, 8) if k <= m)
    tiles = -(-v // 128)
    per = -(-tiles // splits)
    assert (splits - 1) * per < tiles  # every split owns a tile
    cols = [[4 * tx + j for j in range(4)] + [64 + 4 * tx + j
                                              for j in range(4)]
            for tx in range(16)]
    neg = np.float32(-1e30)
    part = []
    for sp in range(splits):
        m = np.full(n, neg, np.float32)
        s = np.zeros(n, np.float32)
        lv = np.full((16, n, length), -np.inf, np.float32)
        li = np.full((16, n, length), topk.IBIG, np.int64)
        for t in range(sp * per, min(sp * per + per, tiles)):
            own = [[t * 128 + c for c in cs if t * 128 + c < v]
                   for cs in cols]
            cm = np.stack([x[:, o].max(axis=1) if o else np.full(n, neg)
                           for o in own]).max(axis=0)
            mn = np.maximum(m, cm)
            se = []
            for o in own:
                acc_se = np.zeros(n, np.float32)
                for c in o:
                    acc_se = acc_se + np.exp(x[:, c] - mn)
                se.append(acc_se)
            for step in (1, 2, 4, 8):
                se = [se[tx] + se[tx ^ step] for tx in range(16)]
            s = s * np.exp(m - mn) + se[0]
            m = mn
            for tx, o in enumerate(own):
                for c in o:  # insert_new: strictly above the last entry
                    enter = x[:, c] > lv[tx, :, -1]
                    cand_v = np.concatenate([lv[tx], x[:, c, None]], 1)
                    cand_i = np.concatenate([li[tx], np.full((n, 1), c)], 1)
                    nv, ni = _merge_top(cand_v, cand_i, length)
                    lv[tx] = np.where(enter[:, None], nv, lv[tx])
                    li[tx] = np.where(enter[:, None], ni, li[tx])
        for o in (8, 4, 2, 1):
            lv, li = map(np.stack, zip(*[_merge_top(
                np.concatenate([lv[tx], lv[tx ^ o]], 1),
                np.concatenate([li[tx], li[tx ^ o]], 1), length)
                for tx in range(16)]))
        part.append((lv[0], li[0], m, s))
    lanes = []
    for lane in range(32):
        lv = np.full((n, length), -np.inf, np.float32)
        li = np.full((n, length), topk.IBIG, np.int64)
        m, s = np.full(n, neg, np.float32), np.zeros(n, np.float32)
        for pv, pi, pm, ps in part[lane::32]:
            lv, li = _merge_top(np.concatenate([lv, pv], 1),
                                np.concatenate([li, pi], 1), length)
            m, s = _merge_ms(m, s, pm, ps)
        lanes.append((lv, li, m, s))
    for o in (16, 8, 4, 2, 1):
        lanes = [_merge_top(np.concatenate([lanes[ln][0], lanes[ln ^ o][0]],
                                           1),
                            np.concatenate([lanes[ln][1], lanes[ln ^ o][1]],
                                           1), length)
                 + _merge_ms(*lanes[ln][2:], *lanes[ln ^ o][2:])
                 for ln in range(32)]
    lv, li, m, s = lanes[0]
    return lv[:, :k], li[:, :k].astype(np.int32), m + np.log(s)


@pytest.mark.parametrize("d", [8, 128, 200])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("mode", ["dyadic", "tie", "negative"])
@pytest.mark.parametrize("splits", [1, 3])
def test_tiled_emulation_matches_plain_version(interpret, d, k, mode,
                                               splits):
    """The f32 K6's order on the 128 x 128 tile (`_tiled_topk`) at D = 8,
    128 (the main model's) and 200 (the widened decoder's), k = 1, 4 (the
    beam's) and 8, on exact logits with many ties, on logits all equal to
    the bias, and on logits all below 0, over V = 700 (six vocab tiles of
    128, the last ragged) in one vocab split or three, N = 20: the indices
    of the plain version (`topk_logits_reference`: `take_top` on the
    materialized logits) and of the TPU kernel under the Pallas
    interpreter, vals and lse within 1e-5 of both."""
    n, v = 20, 700
    h, W, b = _mode_case(n, d, v, mode, seed=d + k)
    ht, Wt, bt = (torch.from_numpy(a) for a in (h, W.T.copy(), b))
    got = _tiled_topk(ht, Wt, bt, k, splits)
    want = [t.numpy() for t in topk.topk_logits_reference(ht, Wt, bt, k)]
    jax_want = [np.asarray(t) for t in jax_topk_logits(
        jnp.asarray(h), jnp.asarray(W), jnp.asarray(b), k, 8, 128)]
    for ref in (want, jax_want):
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_allclose(got[0], ref[0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[2], ref[2], atol=1e-5, rtol=0)
