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


def _fma(a, b, c):
    """f32 fmaf(a, b, c), emulated: the exact product and sum in f64 (a
    product of two f32 values is exact there), rounded once to f32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _softmax5(s):
    """csrc/star_wide.cu `softmax5` on scores (5, ...): max and sum in
    context order, each weight by a division."""
    m = np.max(s, axis=0)
    e = np.exp(s - m).astype(np.float32)
    total = np.zeros_like(e[0])
    for j in range(5):
        total = total + e[j]
    return e / total


def _wide_star(q, k_ctx, v_ctx, heads, size):
    """The wide K5's arithmetic in its order (csrc/star_wide.cu) on f32
    rows q (N, D) and contexts (5, N, D), with the lane partition
    `star_kernel.wide_plan` gives elements of `size` bytes (4: the f32
    kernel's; 2: the bf16 kernel's, on these f32 values). Group path: lane
    g holds elements [g E, g E + E') (E' short on a last, ragged lane),
    at most two heads; its part of each by an fmaf chain in element order;
    the parts of the lanes inside a head summed by the segmented suffix
    scan (offsets 1, 2, 4, ..., a lane adding the sum at its offset while
    every lane of its window is inside the head), the head's total at the
    lane where it starts (its part plus the scan of the next lane), taken
    from there by the head's other lanes; the scores divided by sqrt(Dh),
    `_softmax5`, and each output an fmaf chain over the contexts. Head
    path: lane l the head's chunks l, l + 32, ..., an fmaf chain over
    them, summed by an xor butterfly (16, 8, 4, 2, 1)."""
    n, d = q.shape
    dh = d // heads
    sqrt_dh = np.float32(np.sqrt(np.float64(dh)))
    plan = star_kernel.wide_plan(d, heads, size)
    kv = plan.chunk_bytes // size
    out = np.zeros((n, d), np.float32)
    if plan.path == "head":
        nch = dh // kv
        for h0 in range(0, d, dh):
            part = np.zeros((32, 5, n), np.float32)
            for lane in range(32):
                for c in range(lane, nch, 32):
                    for e in range(h0 + c * kv, h0 + c * kv + kv):
                        part[lane] = _fma(q[None, :, e], k_ctx[:, :, e],
                                          part[lane])
            for o in (16, 8, 4, 2, 1):
                part = np.stack([part[ln] + part[ln ^ o]
                                 for ln in range(32)])
            w = _softmax5(part[0] / sqrt_dh)
            for e in range(h0, h0 + dh):
                acc = np.zeros(n, np.float32)
                for j in range(5):
                    acc = _fma(w[j], v_ctx[j, :, e], acc)
                out[:, e] = acc
        return out
    big = plan.chunks * kv  # E
    lanes = plan.lanes
    first = [g * big for g in range(lanes)]
    held = [min(big, d - a) for a in first]
    hf = [a // dh for a in first]
    bound = [(h + 1) * dh for h in hf]
    two = [a + m > bnd for a, m, bnd in zip(first, held, bound)]
    hl = [h + t for h, t in zip(hf, two)]
    link = [g + 1 < lanes and held[g] == big
            and first[g] + big < (hl[g] + 1) * dh for g in range(lanes)]
    inside = [link[g] and not two[g] for g in range(lanes)]
    span = -(-dh // big) + 1
    offsets = [o for o in (1, 2, 4, 8, 16) if o < span]
    takes, on = [], list(inside)
    for o in offsets:
        takes.append(list(on))
        on = [on[g] and g + o < lanes and on[g + o] for g in range(lanes)]
    pf = np.zeros((lanes, 5, n), np.float32)
    pl = np.zeros((lanes, 5, n), np.float32)
    for g in range(lanes):
        for e in range(first[g], first[g] + held[g]):
            if e < bound[g]:
                pf[g] = _fma(q[None, :, e], k_ctx[:, :, e], pf[g])
            else:
                pl[g] = _fma(q[None, :, e], k_ctx[:, :, e], pl[g])
    u = pf.copy()
    for o, take in zip(offsets, takes):
        u = np.stack([u[g] + u[g + o] if take[g] else u[g]
                      for g in range(lanes)])
    own = [pl[g] if two[g] else pf[g] for g in range(lanes)]
    total = [own[g] + u[g + 1] if link[g] else own[g]
             for g in range(lanes)]
    for g in range(lanes):
        gs = hf[g] * dh // big
        tf = total[gs] if gs != g else (pf[g] if two[g] else total[g])
        wf = _softmax5(tf / sqrt_dh)
        wl = _softmax5(total[g] / sqrt_dh)
        for e in range(first[g], first[g] + held[g]):
            w = wf if e < bound[g] else wl
            acc = np.zeros(n, np.float32)
            for j in range(5):
                acc = _fma(w[j], v_ctx[j, :, e], acc)
            out[:, e] = acc
    return out


@pytest.mark.parametrize("b,l,d,heads", [
    (3, 31, 96, 8), (3, 1, 96, 8), (3, 2, 96, 8),   # the widened star's
    (3, 31, 100, 4), (5, 2, 100, 4),                # Dh = 25
    (3, 31, 512, 8), (3, 1, 512, 8),                # the D = 512 rows'
    (3, 7, 45, 3), (5, 2, 45, 3),                   # odd D, 3 heads
    (3, 5, 130, 65), (1, 3, 544, 2),                # the head path
])
@pytest.mark.parametrize("size", [4, 2])
def test_wide_emulation_matches_ring_reference(interpret, b, l, d, heads,
                                               size):
    """The wide K5's lane partition and order of sums (`_wide_star`), with
    the f32 kernel's partition and the bf16 kernel's (D = 96: 12 lanes of 8,
    heads of 12 straddling lanes; D = 100: 25 lanes of 4, heads of 25), at
    L = 1, 2, 7 and 31 and odd numbers of sequences, on the group path and
    the head path (D = 130 in 65 heads of 2, D = 544 in 2 heads of 272 in
    f32): within 1e-5 of `ring_reference` and of the TPU kernel under the
    Pallas interpreter on the contexts the JAX model builds."""
    xs = _ring_inputs(b, l, d, seed=4)
    t = [torch.from_numpy(x) for x in xs]
    want = star_kernel.ring_reference(*t, heads).numpy()
    jax_want = np.asarray(_jax_ring(*map(jnp.asarray, xs), heads))
    n = b * l
    q = xs[0].reshape(n, d)
    k_ctx, v_ctx = (star_kernel.contexts(x, xe, xs_).reshape(5, n, d)
                    .numpy() for x, xe, xs_ in ((t[1], t[3], t[5]),
                                                (t[2], t[4], t[6])))
    got = _wide_star(q, k_ctx, v_ctx, heads, size).reshape(b, l, d)
    for ref in (want, jax_want):
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
