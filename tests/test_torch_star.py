"""The port's Star codec against the JAX package's on the CPU at f32: K5's
plain versions and its autograd Function (forward and the analytic
backward, folded onto the ring) against the TPU kernel under the Pallas
interpreter and `jax.grad` through it, on stacked contexts and on the ring
as the JAX model stacks it; each star module on the same weights through
the weight bridge; and the bridge's round trip on star trees."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.models import star as jstar
from deepsc_gan_tpu.models.transceiver import make_model as make_flax_model
from deepsc_gan_tpu.ops.masks import create_masks as jax_create_masks
from deepsc_gan_tpu.ops.pallas.star import (
    set_star_kernel_mode,
    star_satellite_attention,
)
from deepsc_gan_tpu_torch.models import star
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops import star_kernel
from deepsc_gan_tpu_torch.train import steps
from deepsc_gan_tpu_torch.utils import convert
from deepsc_gan_tpu_torch.utils.config import Config as TorchConfig
from test_torch_model import port_config

STAR_TRAINED = str(Path(__file__).resolve().parent.parent / "results"
                   / "star_best_params.pkl")
# (b, l, d, heads, tolerance): a tiny shape and the model's (D = 128, 8
# heads), at the tolerances of tests/test_pallas_star.py; for the ring also
# L = 1 and 2 (the neighbours coincide with each other or with the row) and
# an odd L
SHAPES = {"tiny": (2, 6, 32, 4, 1e-5), "full": (4, 31, 128, 8, 1e-4),
          "L1": (3, 1, 32, 4, 1e-5), "L2": (3, 2, 32, 4, 1e-5),
          "odd": (2, 7, 32, 4, 1e-5)}
# "tiny", "full": independent stacked contexts, which only the plain
# version and the backward take; "ring_*": the unstacked ring
CASES = ["tiny", "full"] + [f"ring_{name}" for name in SHAPES]
RING = ("q", "kh", "vh", "ke", "ve", "ks", "vs")


@pytest.fixture
def interpret():
    set_star_kernel_mode("interpret")
    try:
        yield
    finally:
        set_star_kernel_mode("auto")


def _inputs(b, l, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, d), np.float32),
            rng.standard_normal((5, b, l, d), np.float32),
            rng.standard_normal((5, b, l, d), np.float32))


def _ring_inputs(b, l, d, seed):
    """q, kh, vh, ke, ve (b, l, d) and ks, vs (b, d) ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, l, d) if i < 5 else (b, d),
                                     np.float32) for i in range(7))


def _jax_ring(q, kh, vh, ke, ve, ks, vs, heads):
    """The TPU kernel on the contexts the JAX model builds from the ring
    (deepsc_gan_tpu/models/star.py:119-125)."""
    b, l, d = q.shape
    nxt = lambda t: jnp.roll(t, -1, axis=1)  # noqa: E731
    prv = lambda t: jnp.roll(t, 1, axis=1)  # noqa: E731
    k_ctx = jnp.stack([nxt(kh), kh, prv(kh), ke,
                       jnp.broadcast_to(ks.reshape(b, 1, d), (b, l, d))])
    v_ctx = jnp.stack([nxt(vh), vh, prv(vh), ve,
                       jnp.broadcast_to(vs.reshape(b, 1, d), (b, l, d))])
    return star_satellite_attention(q, k_ctx, v_ctx, heads)


def _case(case):
    """(ring?, b, l, d, heads, tolerance)."""
    ring = case.startswith("ring_")
    return (ring, *SHAPES[case.removeprefix("ring_")])


@pytest.mark.parametrize("case", CASES)
def test_satellite_matches_interpreted_kernel(interpret, case):
    """Against the TPU kernel: on stacked contexts, the plain version; on
    the ring, its plain version, the wrapper on the CPU, and the Function
    through K5 and through the plain version."""
    ring, b, l, d, heads, tol = _case(case)
    if not ring:
        q, k, v = _inputs(b, l, d, seed=1)
        want = np.asarray(star_satellite_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads))
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        got = {"reference": star_kernel.satellite_reference(
            tq.reshape(b * l, d), tk.reshape(5, b * l, d),
            tv.reshape(5, b * l, d), heads).reshape(b, l, d)}
    else:
        xs = _ring_inputs(b, l, d, seed=1)
        want = np.asarray(_jax_ring(*map(jnp.asarray, xs), heads))
        t = [torch.from_numpy(x) for x in xs]
        got = {"ring_reference": star_kernel.ring_reference(*t, heads),
               "wrapper": star_kernel.star_satellite(*t, heads),
               "function": star_kernel.satellite_attention(*t, heads),
               "plain": star_kernel.plain_satellite(*t, heads)}
    for name, out in got.items():
        np.testing.assert_allclose(out.numpy(), want, atol=tol, rtol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_satellite_backward_matches_jax_vjp(interpret, case):
    """Against `jax.grad` through the kernel's custom VJP, for a weighted
    sum of the output: on stacked contexts, `satellite_backward`; on the
    ring, autograd through the Function (K5 and plain paths) for all seven
    inputs, against `jax.grad` through the JAX model's roll, stack and
    broadcast."""
    ring, b, l, d, heads, tol = _case(case)
    g = np.random.default_rng(3).standard_normal((b, l, d), np.float32)
    if not ring:
        xs = _inputs(b, l, d, seed=2)
        want = jax.grad(lambda q, k, v: jnp.sum(
            star_satellite_attention(q, k, v, heads) * g),
            argnums=(0, 1, 2))(*map(jnp.asarray, xs))
        got = {"satellite_backward": star_kernel.satellite_backward(
            *(torch.from_numpy(x) for x in xs), torch.from_numpy(g), heads)}
        names = "qkv"
    else:
        xs = _ring_inputs(b, l, d, seed=2)
        want = jax.grad(lambda *a: jnp.sum(_jax_ring(*a, heads) * g),
                        argnums=tuple(range(7)))(*map(jnp.asarray, xs))
        got = {}
        for fn in (star_kernel.satellite_attention,
                   star_kernel.plain_satellite):
            leaves = [torch.from_numpy(x).requires_grad_(True) for x in xs]
            (fn(*leaves, heads) * torch.from_numpy(g)).sum().backward()
            got[fn.__name__] = [t.grad for t in leaves]
        names = RING
    for fn_name, grads in got.items():
        for name, t, w in zip(names, grads, want):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=tol,
                                       rtol=tol, err_msg=f"{fn_name} d{name}")


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
            np.float32)), tree)


def _port_init_tree(module, cfg, seed):
    """The flax tree of `module` after the port's flax-style init from
    `seed`, every leaf moved by N(0, 0.1) noise from numpy (flax's own init
    would cost a compile per shape)."""
    steps.init_params(module, seed)
    return _noisy(convert.state_dict_to_flax(module.state_dict(), cfg), seed)


def star_params(jcfg, seed: int, variant: str):
    """(flax model, params) of a star `variant` for the JAX config `jcfg`,
    the params made by `_port_init_tree`. The bridge that carries them is
    held to flax's own tree by `test_weight_bridge_round_trip_star`."""
    tcfg = port_config(jcfg)
    return (make_flax_model(jcfg, variant),
            _port_init_tree(make_model(tcfg, variant), tcfg, seed))


MODULES = ("encoder_layer", "encoder_layer_separate", "decoder_layer",
           "decoder_layer_separate", "SE", "SEncoder", "SD_tied", "SDecoder")


def _module_cases(cfg):
    """name -> (flax module, port module, call kind)."""
    c, d, h, f, v = (cfg.cycle_num, cfg.decoder_d_model,
                     cfg.decoder_num_heads, cfg.decoder_d_ff, cfg.vocab_size)
    return {
        "encoder_layer": (jstar.StarEncoderLayer(c, d, h, f),
                          star.StarEncoderLayer(c, d, h, f), "enc_layer"),
        "encoder_layer_separate": (
            jstar.StarEncoderLayer(c, d, h, f, separate_relay=True,
                                   share_ffn_ln=True),
            star.StarEncoderLayer(c, d, h, f, separate_relay=True,
                                  share_ffn_ln=True), "enc_layer"),
        "decoder_layer": (jstar.StarDecoderLayer(c, d, h, f),
                          star.StarDecoderLayer(c, d, h, f), "dec_layer"),
        "decoder_layer_separate": (
            jstar.StarDecoderLayer(c, d, h, f, separate_relay=True),
            star.StarDecoderLayer(c, d, h, f, separate_relay=True),
            "dec_layer"),
        "SE": (jstar.SE(c, h, d, f, v), star.SE(c, h, d, f, v), "enc"),
        "SEncoder": (jstar.SEncoder(c, 2, h, d, f, v),
                     star.SEncoder(c, 2, h, d, f, v), "enc"),
        "SD_tied": (jstar.SD(c, d, h, f, v, tie_embeddings=True),
                    star.SD(c, d, h, f, v, tie_embeddings=True), "dec"),
        "SDecoder": (jstar.SDecoder(c, 2, d, h, f, v),
                     star.SDecoder(c, 2, d, h, f, v), "dec"),
    }


@pytest.mark.parametrize("case", MODULES)
def test_star_module_matches_flax(tiny_cfg, case):
    """Each module (dropout off) on the same weights: the layers' outputs
    and relay states, the encoders' outputs, the decoders' logits."""
    fmod, tmod, kind = _module_cases(tiny_cfg)[case]
    rng = np.random.default_rng(5)
    b, l, d = 3, tiny_cfg.seq_len, tiny_cfg.decoder_d_model
    e = rng.standard_normal((b, l, d), np.float32)
    tokens = rng.integers(1, tiny_cfg.vocab_size, (b, l)).astype(np.int32)
    tokens[:, l - 3:] = 0
    tar = tokens[:, :-1]
    mask = np.asarray(jax_create_masks(jnp.asarray(tokens), jnp.asarray(tar),
                                       0)[1])
    args = {"enc_layer": (e,), "enc": (tokens,),
            "dec_layer": (rng.standard_normal((b, l - 1, d), np.float32), e,
                          mask),
            "dec": (tar, e, mask)}[kind]
    jargs = [jnp.asarray(a) for a in args]
    params = _port_init_tree(tmod, port_config(tiny_cfg), 6)
    want = fmod.apply({"params": params}, *jargs, deterministic=True)
    tmod.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    if kind == "enc":
        targs = [targs[0].long(), None]
    elif kind == "dec":
        targs = [targs[0].long(), targs[1], targs[2], None]
    with torch.no_grad():
        got = tmod(*targs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("which", ["star_best_params", "star_multi_init"])
def test_weight_bridge_round_trip_star(tiny_cfg, which):
    """flax tree -> state_dict -> flax tree gives every leaf back, shape and
    value, and the state_dict loads strictly into the port's model. On the
    committed single-block star weights and on a multi-layer init (the star
    banks' `out` kernels are (H, Dh, D), as the vanilla ones)."""
    if which == "star_best_params":
        if not Path(STAR_TRAINED).exists():
            pytest.skip(f"{STAR_TRAINED} is not in this checkout")
        tree = convert.load_params_pickle(STAR_TRAINED)
        cfg, variant = TorchConfig(tie_embeddings=True, seq_len=31), "star"
    else:
        # flax's init traced for its tree alone, the leaves then drawn
        # from numpy
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda: make_flax_model(
            tiny_cfg, "star_multi").init(
            {"params": key}, jnp.zeros((1, 12), jnp.int32),
            jnp.zeros((1, 11), jnp.int32), key, jnp.zeros((1, 12, 8)),
            0.0))["params"]
        rng = np.random.default_rng(2)
        tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), shapes)
        cfg, variant = port_config(tiny_cfg), "star_multi"
    sd = convert.flax_to_state_dict(tree)
    make_model(cfg, variant).load_state_dict(sd, strict=True)
    want, got = _leaves(tree), _leaves(convert.state_dict_to_flax(sd, cfg))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
