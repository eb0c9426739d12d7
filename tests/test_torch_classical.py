"""The port's classical baseline (Huffman + turbo + QAM) against the JAX
package's on the CPU: the Huffman code tables, the QAM modem, the RSC
encoder (and a trellis worked by hand), the BCJR's LLRs within 1e-5 of
their largest, the turbo decoder's bits (noiseless and noisy), the sweep's
rows (turbo and uncoded, block_k 64 and 128) and `cli baseline`'s pickle."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu import cli as jax_cli
from deepsc_gan_tpu.baselines import turbo as jax_turbo
from deepsc_gan_tpu.baselines.huffman import HuffmanCodec as JaxHuffman
from deepsc_gan_tpu.baselines.modem import QamModem as JaxQam
from deepsc_gan_tpu.baselines.pipeline import (
    classical_sweep as jax_classical_sweep,
)
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.baselines import turbo
from deepsc_gan_tpu_torch.baselines.huffman import HuffmanCodec
from deepsc_gan_tpu_torch.baselines.modem import QamModem
from deepsc_gan_tpu_torch.baselines.pipeline import classical_sweep
import test_torch_model  # noqa: F401  (one PyTorch thread per worker)

# the sentences of the JAX package's CLI baseline test
SENTS = [
    "the house rose and observed a minute s silence",
    "this is all in accordance with the principles",
    "the principles that we have always upheld",
    "thank you i shall do so gladly",
] * 3


def _zipf_sentences(n, seed, words=60):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, words + 1)
    p /= p.sum()
    return [" ".join(f"w{i}" for i in rng.choice(words, rng.integers(4, 12),
                                                 p=p)) for _ in range(n)]


def test_huffman_tables_equal_jax():
    for sents in (SENTS, _zipf_sentences(50, 0)):
        words = [s.split() for s in sents]
        got, want = HuffmanCodec(words), JaxHuffman(words)
        assert got.code == want.code
        for w in words[:5]:
            bits = got.encode(w)
            assert np.array_equal(bits, want.encode(w))
            assert got.decode(bits) == want.decode(bits) == list(w)
            assert np.array_equal(got.word_lengths(w), want.word_lengths(w))
        noisy = got.encode(words[0]) ^ (np.arange(len(got.encode(words[0])))
                                        % 5 == 0)
        assert got.decode(noisy, 3) == want.decode(noisy, 3)


@pytest.mark.parametrize("bits_per_symbol", [2, 4, 6])
def test_qam_equals_jax(bits_per_symbol):
    rng = np.random.default_rng(bits_per_symbol)
    bits = rng.integers(0, 2, 601).astype(np.uint8)
    got, want = QamModem(bits_per_symbol), JaxQam(bits_per_symbol)
    sym = got.modulate(bits)
    assert np.array_equal(sym, want.modulate(bits))
    y = sym + 0.3 * (rng.standard_normal(len(sym))
                     + 1j * rng.standard_normal(len(sym)))
    assert np.array_equal(got.llr(y, 0.4), want.llr(y, 0.4))


def test_rsc_encode_matches_hand_trellis_and_jax():
    # worked by hand, u = 1 0 1 1 0 0 1 from registers (s1, s2) = (0, 0):
    # a = u^s1^s2, parity a^s2, then (s1, s2) = (a, s1)
    u = np.array([1, 0, 1, 1, 0, 0, 1], dtype=np.uint8)
    assert turbo.rsc_encode(u).tolist() == [1, 1, 0, 0, 1, 0, 0]
    # the decoder's trellis tables (state s1*2 + s2) give the same stream
    block = np.random.default_rng(0).integers(0, 2, (3, 40))
    walked = np.zeros_like(block)
    for r, row in enumerate(block):
        state = 0
        for k, bit in enumerate(row):
            walked[r, k] = turbo._PB[state, bit]
            state = turbo._NS[state, bit]
    assert np.array_equal(turbo.rsc_encode(block), walked)
    assert np.array_equal(turbo.rsc_encode(block),
                          jax_turbo.rsc_encode(block))


@pytest.mark.parametrize("scale", [0.5, 4.0])
def test_bcjr_llrs_equal_jax(scale):
    rng = np.random.default_rng(int(scale * 10))
    ls, lp, la = (scale * rng.standard_normal((5, 64)).astype(np.float32)
                  for _ in range(3))
    want = np.asarray(jax_turbo._bcjr(jnp.asarray(ls), jnp.asarray(lp),
                                      jnp.asarray(la)))
    got = turbo.bcjr(torch.tensor(ls), torch.tensor(lp),
                     torch.tensor(la)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("sigma", [0.0, 0.8])
def test_turbo_decode_bits_equal_jax(sigma):
    k = 64
    got_tc = turbo.TurboCodec(block_k=k, iters=3, seed=1, device="cpu")
    want_tc = jax_turbo.TurboCodec(block_k=k, iters=3, seed=1)
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 4 * k - 9).astype(np.uint8)
    sym, n = got_tc.encode(bits)
    want_sym, want_n = want_tc.encode(bits)
    assert n == want_n and np.array_equal(sym, want_sym)
    normals = rng.standard_normal(sym.shape).astype(np.float32)
    if sigma:
        llr = turbo.TurboCodec.awgn_llr(sym, 2.0, torch.tensor(normals))
    else:
        llr = 2.0 * sym / 0.25
    got = got_tc.decode(llr, n)
    assert np.array_equal(got, want_tc.decode(llr, n))
    if not sigma:
        assert np.array_equal(got, bits)


def test_awgn_llr_equals_jax_on_its_draws():
    sym = 1.0 - 2.0 * np.random.default_rng(3).integers(
        0, 2, (3, 2, 16)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jax_turbo.TurboCodec.awgn_llr(sym, 3.0, key, attack_pnr_db=5.0)
    normals = torch.tensor(np.asarray(jax.random.normal(key, sym.shape)))
    got = turbo.TurboCodec.awgn_llr(sym, 3.0, normals, attack_pnr_db=5.0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    drawn = turbo.TurboCodec.awgn_llr(sym, 3.0,
                                      torch.Generator().manual_seed(0))
    assert drawn.shape == sym.shape


@pytest.mark.parametrize("coding,block_k", [("turbo", 64), ("turbo", 128),
                                            ("none", 64)])
def test_classical_sweep_equals_jax(coding, block_k):
    sents = _zipf_sentences(24, 5, words=30)
    kw = dict(block_k=block_k, iters=2, mod_bits=4, pnr_db=10.0, seed=3,
              verbose=False, coding=coding)
    snrs = [4.0, 9.0, 16.0]
    got = classical_sweep(sents, snrs, device="cpu", **kw)
    want = jax_classical_sweep(sents, snrs, **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-12)
    if coding == "turbo":
        assert got[-1][2] == 1.0


def test_cli_baseline_writes_the_jax_pickle(tmp_path):
    data = tmp_path / "sents.pkl"
    with open(data, "wb") as f:
        pickle.dump(SENTS, f)
    flags = ["--data", str(data), "--block-k", "128", "--iters", "3",
             "--mod-bits", "4", "--snrs", "10,16"]
    jax_cli.main(["baseline", *flags, "--out", str(tmp_path / "j.pkl")])
    res = cli.main(["baseline", *flags, "--out", str(tmp_path / "t.pkl"),
                    "--device", "cpu"])
    with open(tmp_path / "j.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "t.pkl", "rb") as f:
        got = pickle.load(f)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-12)
    assert got == res["rows"] and len(res["seconds"]) == 2
    assert got[1][2] > 0.95 and got[1][1] < got[1][2]
