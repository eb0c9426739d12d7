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
{...}}` with numpy leaves, and load with numpy alone.
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
