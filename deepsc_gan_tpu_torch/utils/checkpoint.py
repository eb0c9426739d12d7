"""Epoch checkpoints of a training run (JAX package `utils/checkpoint.py`):
the layout `<checkpoint_path>/<variant>/<epoch>/`, keep-last-`max_to_keep`,
and a save of everything exact resume needs, so `cli train --resume`
continues bit-identical to the run that was not stopped.

A save holds the parameters, Adam's moments and each parameter's count,
the update count (`TrainState.step`), the EMA shadow when it is on, and
`extra` (the CLI's: the training generator's state). The format is the
port's own, one `torch.save` file of CPU tensors a checkpoint
(`state.pt`), loaded with `weights_only=True`; it does not read the JAX
package's Orbax checkpoints (nor they the port's). Saves are synchronous.

`restore` follows the JAX package's rules for the EMA shadow: a run
without EMA ignores a saved shadow; a run with EMA restores the saved
one, or re-seeds the shadow from the restored parameters when the
checkpoint has none.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

from deepsc_gan_tpu_torch.train.steps import TrainState
from deepsc_gan_tpu_torch.utils.convert import adam_state, set_adam_state

FILE = "state.pt"


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}


class CheckpointManager:
    """Epoch checkpoints under `directory`, the newest `max_to_keep`
    kept."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def epochs(self):
        """The saved epochs, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, FILE)))

    def latest_epoch(self) -> Optional[int]:
        saved = self.epochs()
        return saved[-1] if saved else None

    def save(self, epoch: int, state: TrainState,
             extra: Optional[dict] = None) -> None:
        """Write checkpoint `epoch` (replacing one of that epoch), then drop
        the oldest beyond `max_to_keep`."""
        named = dict(state.model.named_parameters())
        adam = adam_state(state.optimizer, named)
        payload = {"params": _host(named),
                   "exp_avg": _host(adam["exp_avg"]),
                   "exp_avg_sq": _host(adam["exp_avg_sq"]),
                   "adam_step": _host(adam["step"]),
                   "step": int(state.step), "extra": extra or {}}
        if state.ema is not None:
            payload["ema"] = _host(state.ema)
        path = os.path.join(self.directory, str(int(epoch)))
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, FILE))
        for old in self.epochs()[:-self.max_to_keep or None]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def _load(self, epoch: Optional[int]) -> dict:
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(os.path.join(self.directory, str(int(epoch)), FILE),
                          map_location="cpu", weights_only=True)

    def restore(self, state: TrainState,
                epoch: Optional[int] = None) -> TrainState:
        """Load checkpoint `epoch` (the latest by default) into `state` in
        place: the parameters, Adam's moments and counts, the update count,
        and the EMA shadow by the rules in the module docstring. The
        model's names and shapes must match the checkpoint's."""
        saved = self._load(epoch)
        named = dict(state.model.named_parameters())
        if set(saved["params"]) != set(named):
            raise ValueError(f"checkpoint parameters do not match the "
                             f"model's under {self.directory}")
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(saved["params"][name])
            if state.ema is not None:
                shadow = saved.get("ema", saved["params"])
                for name, t in state.ema.items():
                    t.copy_(shadow[name])
        set_adam_state(state.optimizer, named, saved["exp_avg"],
                       saved["exp_avg_sq"], saved["adam_step"])
        state.step = saved["step"]
        return state

    def extra(self, epoch: Optional[int] = None) -> dict:
        """The `extra` saved with checkpoint `epoch` (the latest by
        default)."""
        return self._load(epoch)["extra"]

    def eval_params(self, epoch: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
        """The parameters evaluation uses from checkpoint `epoch` (the
        latest by default): the EMA shadow when it was saved, else the
        parameters (name -> CPU tensor, a state_dict)."""
        saved = self._load(epoch)
        return saved.get("ema", saved["params"])

    def close(self) -> None:
        """Nothing to join: saves are synchronous (the JAX package's
        manager joins its asynchronous writes here)."""


def save_params(path: str, params: Dict[str, Any]) -> None:
    """A params-only save (name -> tensor) for evaluation-time
    artifacts."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(_host(params), path)


def load_params(path: str,
                template: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """The params `save_params` wrote; with a `template` (name -> tensor)
    each cast to the template's dtype and device, the names checked."""
    params = torch.load(path, map_location="cpu", weights_only=True)
    if template is None:
        return params
    if set(params) != set(template):
        raise ValueError(f"{path}: parameter names differ from the "
                         f"template's")
    return {n: params[n].to(template[n].device, template[n].dtype)
            for n in template}
