"""The port's transceiver against the JAX package's on the CPU at f32, with
the same weights through the weight bridge: the bridge's round trip, and
each stage of the serving path. Also the helpers the port's other parity
tests import (`port_config`, `flax_params`)."""

import dataclasses
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.models.transceiver import make_model as make_flax_model
from deepsc_gan_tpu.ops.masks import create_masks as jax_create_masks
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.utils import convert
from deepsc_gan_tpu_torch.utils.config import Config as TorchConfig

# One intra-op thread for PyTorch on the CPU: the test run gives each of
# several workers its own process, and PyTorch's default of a thread per
# core in each of them oversubscribes the cores many times over (a
# tiny-width CLI test took 0.2 s alone and 40 s beside the others). The
# other port test modules import this one, and the workers import every
# test module when they collect, so the setting holds in every worker.
torch.set_num_threads(1)

ATOL = 1e-5
TRAINED = str(Path(__file__).resolve().parent.parent / "results"
              / "plain_best_params.pkl")


def port_config(jax_cfg, **kw) -> TorchConfig:
    """The port's Config with every field it shares with `jax_cfg`."""
    names = {f.name for f in dataclasses.fields(TorchConfig)}
    fields = {n: getattr(jax_cfg, n) for n in names}
    fields.update(kw)
    return TorchConfig(**fields)


def flax_params(cfg, seed: int = 0, variant: str = "transformer"):
    """(flax model, params) of `variant` for `cfg`: flax's init, then every
    leaf moved by N(0, 0.1) noise from numpy so biases, LayerNorm scales and
    the tied decoder's final bias are not at their trivial init values."""
    model = make_flax_model(cfg, variant)
    inp = jnp.zeros((2, cfg.seq_len), jnp.int32)
    tar = jnp.zeros((2, cfg.seq_len - 1), jnp.int32)
    p = jnp.zeros((2, cfg.seq_len, cfg.channel_dim), jnp.float32)
    key = jax.random.PRNGKey(seed)
    init = jax.jit(lambda k, inp, tar, p: model.init(
        {"params": k, "dropout": k}, inp, tar, k, p, 0.0,
        deterministic=True))
    params = init(key, inp, tar, p)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.standard_normal(
            a.shape).astype(np.float32)), params)
    return model, params


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("tie", [False, True])
def test_weight_bridge_round_trip(tiny_cfg, tie):
    cfg = tiny_cfg.replace(tie_embeddings=tie)
    _, params = flax_params(cfg, seed=1)
    model = make_model(port_config(cfg))
    convert.load_into(model, params)  # strict: names and shapes match
    assert convert.is_tied(params) == tie
    back = convert.state_dict_to_flax(model.state_dict(), port_config(cfg))
    want, got = _leaves(params), _leaves(back)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_params_pickle_loads_with_numpy_alone(tmp_path):
    with open(TRAINED, "rb") as f:
        want = _leaves(pickle.load(f)["params"])
    got = _leaves(convert.load_params_pickle(TRAINED))
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps({"params": {"x": pytest.raises}}))
    with pytest.raises(pickle.UnpicklingError):
        convert.load_params_pickle(str(bad))


@pytest.mark.parametrize("tie", [False, True])
def test_stages_match_jax(tiny_cfg, tiny_batch, tie):
    """encode, transmit (injected noise, nonzero perturbation),
    channel_decode, the decoder's hidden states and final_projection."""
    cfg = tiny_cfg.replace(tie_embeddings=tie)
    jmodel, params = flax_params(cfg, seed=2)
    model = convert.load_into(make_model(port_config(cfg)), params).eval()
    v = {"params": params}
    inp = jnp.asarray(tiny_batch)
    tar = inp[:, :-1]
    inp_t = torch.tensor(np.asarray(inp)).long()
    tar_t = inp_t[:, :-1]
    jm = jax_create_masks(inp, tar)
    tm = create_masks(inp_t, tar_t)

    with torch.no_grad():
        tx_j = jmodel.apply(v, inp, jm[0], method="encode")
        tx_t = model.encode(inp_t, tm[0])
        np.testing.assert_allclose(tx_t.numpy(), np.asarray(tx_j), atol=ATOL)

        key = jax.random.PRNGKey(7)
        p = 0.01 * jax.random.normal(jax.random.PRNGKey(8), tx_j.shape)
        n_std, pnr_db = 0.3, -3.0
        y_j = jmodel.apply(v, key, tx_j, p, pnr_db, n_std, method="transmit")
        noise = np.asarray(jax.random.normal(key, tx_j.shape, jnp.float32))
        y_t = model.transmit(torch.tensor(np.asarray(tx_j)),
                             torch.tensor(noise), n_std,
                             torch.tensor(np.asarray(p)), pnr_db)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)

        y = np.asarray(y_j)
        mem_j = jmodel.apply(v, jnp.asarray(y), method="channel_decode")
        mem_t = model.channel_decode(torch.tensor(y))
        np.testing.assert_allclose(mem_t.numpy(), np.asarray(mem_j),
                                   atol=ATOL)

        mem = np.asarray(mem_j)
        h_j = jmodel.apply(v, tar, jnp.asarray(mem), jm[1], jm[2],
                           deterministic=True, apply_final=False,
                           method="_semantic_decode")
        h_t = model._semantic_decode(tar_t, torch.tensor(mem), tm[1],
                                     tm[2], apply_final=False)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)

        h = np.asarray(h_j)
        lo_j = jmodel.apply(v, jnp.asarray(h), method="final_projection")
        lo_t = model.final_projection(torch.tensor(h))
        np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), atol=ATOL)
