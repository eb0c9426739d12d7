"""Weight bridge between the JAX package's flax param trees and the port's
`state_dict`s.

Layouts (JAX package `ops/attention.py`, `models/transformer.py`,
`train/steps.py:137-148`):
- a Dense kernel (in, out) is an `nn.Linear` weight (out, in);
- the attention kernels `wq/wk/wv` (D, H, Dh) are weights (H*Dh, D), the
  output kernel `out` (H, Dh, D) a weight (D, H*Dh) with its bias: in the
  vanilla `*mha` modules and in the star banks (`att_satellite`,
  `att_relay`, `multi_tar`) alike;
- LayerNorm `scale` is `weight`; the embedding `embed/embedding/embedding`
  is `embed.embedding.weight`;
- flax's `layer{i}` is the port's `layers.{i}` (the single-block star
  codec's `block` keeps its name);
- a tied decoder has `final_bias` (and projects with the embedding table),
  an untied one a `final_layer` Dense;
- the GAN transceivers' `generator` is two Denses (`fc0`, `fc1`); the CNN
  variants' `cnn*` conv kernels (width, in, out) are weights (out, in,
  width), and their sequence LayerNorm `norm` keeps `scale` as `weight`.

The committed `results/*_params.pkl` files are `{"params": tree, "recipe":
{...}}` with numpy leaves, and load with numpy alone. MINE's tree (`fc0`,
`fc1`, `fc2` Denses, `models/mine.py`) goes both ways through the same two
functions.

Adam's state: optax's `ScaleByAdamState` (`mu`, `nu` trees shaped as the
params, and `count`) maps to and from `torch.optim.Adam`'s per-parameter
`exp_avg`, `exp_avg_sq` and `step` (`adam_state`, `set_adam_state` by
parameter name; `adam_state_to_flax`, `load_flax_adam_state` by flax tree),
so both packages can start from one mid-training state. Both count the
updates made and correct the bias with the count after the increment.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Mapping

import numpy as np
import torch

from deepsc_gan_tpu_torch.utils.config import Config

_ATTN_IN = ("wq", "wk", "wv")


class _NumpyUnpickler(pickle.Unpickler):
    """Resolves only numpy's globals (the params pickles hold nothing
    else), mapping numpy 2's `numpy._core` to `numpy.core` on a numpy that
    lacks it."""

    def find_class(self, module, name):
        if module.split(".")[0] != "numpy":
            raise pickle.UnpicklingError(
                f"params pickle refers to {module}.{name}; only numpy "
                f"objects are allowed")
        if module.startswith("numpy._core") and not hasattr(np, "_core"):
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def load_params_pickle(path: str) -> dict:
    """-> the flax param tree (nested dicts of numpy arrays) of a
    `results/*_params.pkl` file (or of a bare pickled tree)."""
    with open(path, "rb") as f:
        blob = _NumpyUnpickler(f).load()
    return blob["params"] if "params" in blob else blob


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _torch_name(path: tuple) -> str:
    parts = [re.sub(r"^layer(\d+)$", r"layers.\1", p) for p in path]
    name = ".".join(parts)
    name = name.replace("embed.embedding.embedding", "embed.embedding.weight")
    return re.sub(r"\.(kernel|scale)$", ".weight", name)


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax param tree -> the port's state_dict (f32 tensors; loading it
    casts to each parameter's dtype)."""
    sd = {}
    for path, a in _flatten(params).items():
        a = a.astype(np.float32)
        if path[-1] == "kernel":
            if path[-2] in _ATTN_IN:      # (D, H, Dh) -> (H*Dh, D)
                a = a.reshape(a.shape[0], -1).T
            elif path[-2].startswith("cnn"):  # (W, in, out) -> (out, in, W)
                a = a.transpose(2, 1, 0)
            elif a.ndim == 3:             # out: (H, Dh, D) -> (D, H*Dh)
                a = a.reshape(-1, a.shape[-1]).T
            else:                         # Dense (in, out) -> (out, in)
                a = a.T
        sd[_torch_name(path)] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def state_dict_to_flax(sd: Mapping[str, torch.Tensor], cfg: Config) -> dict:
    """The inverse of `flax_to_state_dict` (f32 numpy leaves); `cfg` gives
    the head counts that split the attention kernels."""
    tree: dict = {}
    # an `out` kernel belongs to an attention module when its module also
    # holds `wq`
    attn_modules = {n[:-len(".wq.weight")] for n in sd
                    if n.endswith(".wq.weight")}
    for name, t in sd.items():
        a = t.detach().float().cpu().numpy()
        parts = name.split(".")
        if parts[-2:] == ["embedding", "weight"]:
            path = parts[:-1] + ["embedding"]
        else:
            path = []
            for i, p in enumerate(parts):
                if p == "layers":
                    continue
                if i > 0 and parts[i - 1] == "layers":
                    p = f"layer{p}"
                path.append(p)
            if path[-1] == "weight":
                is_ln = path[-2].startswith(("ln", "layernorm")) \
                    or path[-2] == "norm"
                path[-1] = "scale" if is_ln else "kernel"
        if path[-1] == "kernel":
            heads = (cfg.encoder_num_heads
                     if path[0] == "semantic_encoder"
                     else cfg.decoder_num_heads)
            if path[-2] in _ATTN_IN:      # (H*Dh, D) -> (D, H, Dh)
                a = a.T.reshape(a.shape[1], heads, -1)
            elif path[-2].startswith("cnn"):  # (out, in, W) -> (W, in, out)
                a = a.transpose(2, 1, 0)
            elif path[-2] == "out" and name.rsplit(".", 2)[0] \
                    in attn_modules:      # (D, H*Dh) -> (H, Dh, D)
                a = a.T.reshape(heads, -1, a.shape[0])
            else:
                a = a.T
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree


def is_tied(params: Mapping) -> bool:
    """Whether a param tree holds a tied decoder (`final_bias`)."""
    return "final_bias" in params["semantic_decoder"]


def load_into(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Load a flax param tree into `model` (strict: every name and shape
    must match)."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model


def adam_state(optimizer: torch.optim.Adam,
               named: Mapping[str, torch.nn.Parameter]) -> Dict[str, dict]:
    """{"exp_avg", "exp_avg_sq", "step"}: name -> tensor (zeros, and a
    step of 0, for a parameter not updated yet), each on its parameter's
    device as the optimizer holds it."""
    out: Dict[str, dict] = {"exp_avg": {}, "exp_avg_sq": {}, "step": {}}
    for name, p in named.items():
        st = optimizer.state.get(p, {})
        for key in ("exp_avg", "exp_avg_sq"):
            out[key][name] = st[key] if key in st else torch.zeros_like(p)
        out["step"][name] = st["step"] if "step" in st \
            else torch.zeros((), dtype=torch.float32)
    return out


def set_adam_state(optimizer: torch.optim.Adam,
                   named: Mapping[str, torch.nn.Parameter],
                   exp_avg: Mapping[str, torch.Tensor],
                   exp_avg_sq: Mapping[str, torch.Tensor], step) -> None:
    """Write each parameter's moments and count (`step`: one number for
    all, or name -> number) into `optimizer` as its own update would have
    left them: f32 moments on the parameter's device, the count an f32
    0-dim tensor on that device when the optimizer is capturable or fused
    (the update reads it there), else on the CPU."""
    on_device = optimizer.defaults.get("capturable") \
        or optimizer.defaults.get("fused")
    for name, p in named.items():
        count = step[name] if isinstance(step, Mapping) else step
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": exp_avg[name].detach().to(p.device, torch.float32)
            .clone(),
            "exp_avg_sq": exp_avg_sq[name].detach()
            .to(p.device, torch.float32).clone()}


def adam_state_to_flax(optimizer: torch.optim.Adam,
                       named: Mapping[str, torch.nn.Parameter],
                       cfg: Config) -> dict:
    """-> {"mu": tree, "nu": tree, "count": int}: Adam's moments as flax
    trees of numpy arrays (optax's `ScaleByAdamState` fields) and its count
    (every parameter's: they must agree)."""
    st = adam_state(optimizer, named)
    counts = {float(c) for c in st["step"].values()}
    if len(counts) != 1:
        raise ValueError(f"the parameters' Adam counts differ: {counts}")
    return {"mu": state_dict_to_flax(st["exp_avg"], cfg),
            "nu": state_dict_to_flax(st["exp_avg_sq"], cfg),
            "count": int(counts.pop())}


def load_flax_adam_state(optimizer: torch.optim.Adam,
                         named: Mapping[str, torch.nn.Parameter],
                         mu: Mapping, nu: Mapping, count) -> None:
    """Load optax's Adam state (`mu`, `nu` flax trees and `count`) into
    `optimizer` for the parameters `named` (strict: every name matches)."""
    exp_avg, exp_avg_sq = flax_to_state_dict(mu), flax_to_state_dict(nu)
    if set(exp_avg) != set(named) or set(exp_avg_sq) != set(named):
        raise ValueError("the Adam moments' names do not match the "
                         "parameters'")
    set_adam_state(optimizer, named, exp_avg, exp_avg_sq,
                   int(np.asarray(count)))
