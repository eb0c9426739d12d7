"""A train step captured as a CUDA graph and replayed without Python in
between its kernels: the counterpart on the card of the JAX package's K
steps in one `lax.scan` dispatch (`train/steps.py:make_train_multi_step`).

The step's host-side state stays on the host and is written into device
memory before each replay: the batch into the graph's static input tensors,
the noise level into a 0-dim tensor, and the learning rate at the
pre-increment count into the capturable Adam's rate tensor
(`TrainState.set_lr`). The caller's `torch.Generator` is registered with
the graph (`CUDAGraph.register_generator_state`): the graph's random kernels
read the generator's seed and offset from device memory, and each replay
sets them from the generator's state and advances it by one step's draws,
so a replay draws the values the eager step would draw at that point of the
generator's stream. The count (`state.step`) goes up on the host after each
replay; Adam's own count is a device tensor the graph advances.

Launch counts: each kernel wrapper adds one to its count where it launches
its kernel (`ops/*_kernel.py`). A capture runs no kernel, so the counts it
added are taken back, and every replay adds them once: after a graphed
dispatch the counts are what the same eager steps would have counted.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from deepsc_gan_tpu_torch.ops import attention_kernel, ce_kernel
from deepsc_gan_tpu_torch.ops import star_kernel, topk_kernel

_KERNELS = (attention_kernel, ce_kernel, star_kernel, topk_kernel)


def _counts():
    """(module, name) of every kernel launch count: each wrapper module's
    integers named `*launches`."""
    return [(mod, name) for mod in _KERNELS for name, value in vars(mod).items()
            if name.endswith("launches") and isinstance(value, int)]


def launch_counts() -> Dict[Tuple[str, str], int]:
    """Every kernel wrapper's launch count, by (module, name)."""
    return {(mod.__name__, name): getattr(mod, name)
            for mod, name in _counts()}


def _add_counts(delta: Dict[Tuple[str, str], int], times: int = 1) -> None:
    for mod, name in _counts():
        setattr(mod, name, getattr(mod, name)
                + times * delta[(mod.__name__, name)])


def warm_up(step: Callable, state, inp, tar, gen, n_std, noise=None):
    """One eager step on a side stream (the warm-up a capture needs: the
    kernels' libraries loaded and their attributes set, Adam's state
    created, the autograd graph exercised) -> (state, loss). It is a real
    step: it draws from `gen`, updates the state and counts its launches."""
    side = torch.cuda.Stream(inp.device)
    side.wait_stream(torch.cuda.current_stream(inp.device))
    with torch.cuda.stream(side):
        state, loss = step(state, inp, tar, gen, n_std, noise)
    torch.cuda.current_stream(inp.device).wait_stream(side)
    return state, loss


class GraphedStep:
    """`forward_backward` and `state.update()` of one train step, captured
    at the shapes of `inp`, `tar` (and `noise`, when given) with static
    input tensors, drawing from `gen`; `replay` runs one step through it.
    The capture raises if it fails."""

    def __init__(self, forward_backward: Callable, state, inp, tar, gen,
                 n_std, noise=None):
        self.inp, self.tar = inp.clone(), tar.clone()
        self.n_std = torch.zeros((), dtype=torch.float32, device=inp.device)
        self._set_n_std(n_std)
        self.noise = None if noise is None else noise.clone()
        self.gen = gen
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(gen)
        before = launch_counts()
        with torch.cuda.graph(self.graph):
            self.loss = forward_backward(state, self.inp, self.tar, gen,
                                         self.n_std, self.noise)
            state.update()
        after = launch_counts()
        # the capture ran nothing: take its counts back, add them per replay
        self.launches = {key: after[key] - before[key] for key in after}
        _add_counts(self.launches, -1)

    def _set_n_std(self, n_std) -> None:
        if isinstance(n_std, torch.Tensor):
            self.n_std.copy_(n_std)
        else:
            self.n_std.fill_(float(n_std))

    def replay(self, state, inp, tar, gen, n_std, noise=None):
        """One step on (inp, tar): the inputs, the noise level and the rate
        into the graph's tensors, the replay (its draws from `gen`, which
        must be the generator of the capture), the count up by one -> the
        step's loss (a 0-dim device tensor the next replay overwrites)."""
        if gen is not self.gen:
            raise ValueError("a graphed step draws from the generator it "
                             "was captured with; pass that one")
        self.inp.copy_(inp)
        self.tar.copy_(tar)
        self._set_n_std(n_std)
        if self.noise is not None:
            self.noise.copy_(noise)
        state.set_lr()
        self.graph.replay()
        _add_counts(self.launches)
        state.step += 1
        return self.loss
