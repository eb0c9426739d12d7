"""A rank's share of a data-parallel batch.

The JAX package's dp step is one program over the global batch (GSPMD):
every batch-wide reduction and every draw is global. Here each rank runs
the port's single-process step on its own rows, inside `sharded(shard)`,
and the pieces that see the whole batch read the active shard:

- the draws (`draw_rows`: the channel's noise and per-row fades, the
  dropout masks, MINE's permutation): every rank draws the GLOBAL batch's
  values from a generator seeded alike on every rank and keeps its own
  rows, so its rows get the values the single-process step gives them;
- the batch-wide statistics (the power normalization, the perturbation's
  scale at the channel, the FGM's global norm, MINE's bound, the loss
  means): sums over the dp group through differentiable collectives, so the
  backward carries the cross-rank terms;
- the update (`sync_grads`): the gradients averaged over the group before
  clipping, Adam and the EMA.

Every rank computes the same global loss. Its backward through a
collective's sum leaves each rank the dp size times its share of the
gradient, so the average over the group is the single-process gradient.

With no shard active every function here returns its input or does
nothing, so the single-process paths are unchanged bit for bit.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Shard:
    """The dp group, this rank's index in it and the group's size; the
    batch's rows are split into `count` equal blocks, block `index` this
    rank's."""

    group: object
    index: int
    count: int


# the shard the running step computes as (`sharded`), per thread and task
_ACTIVE: ContextVar[Optional[Shard]] = ContextVar("dp_shard", default=None)


def dp_group():
    """The active shard's group, or None."""
    shard = _ACTIVE.get()
    return None if shard is None else shard.group


@contextlib.contextmanager
def sharded(shard: Optional[Shard]):
    """Run the block as the rank `shard` of a data-parallel batch (None:
    as a single process)."""
    token = _ACTIVE.set(shard)
    try:
        yield shard
    finally:
        _ACTIVE.reset(token)


def global_rows(rows: int) -> int:
    """The global batch's rows, given a rank's."""
    shard = _ACTIVE.get()
    return rows if shard is None else rows * shard.count


def own_rows(t: Optional[torch.Tensor], axis: int = 0, shard=None):
    """The rank's block of a global tensor's rows along `axis` (the active
    shard's, or `shard`'s); `t` itself with no shard or for None."""
    shard = shard or _ACTIVE.get()
    if t is None or shard is None:
        return t
    n = t.shape[axis]
    if n % shard.count:
        raise ValueError(f"{n} rows do not split over {shard.count} ranks")
    n //= shard.count
    return t.narrow(axis, shard.index * n, n)


def draw_rows(draw: Callable, shape, axis: int = 0) -> torch.Tensor:
    """`draw(shape)` for a tensor whose axis `axis` is the batch: under a
    shard the global batch's values are drawn and the rank's rows kept."""
    shard = _ACTIVE.get()
    if shard is None:
        return draw(tuple(shape))
    shape = list(shape)
    shape[axis] *= shard.count
    return own_rows(draw(tuple(shape)), axis, shard)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`, differentiable (the backward sums the
    gradients over the group)."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """x's elementwise maximum over `group`; no gradient."""
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


class _GatherRows(torch.autograd.Function):
    """The ranks' row blocks concatenated in rank order on every rank; the
    backward sums the gradient over the group and keeps the rank's block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.index = dist.get_rank(group)
        ctx.rows = x.shape[0]
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of x, in rank order (differentiable)."""
    return _GatherRows.apply(x, group)


def global_mean(local_mean: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the global batch from a rank's mean over its rows
    (every rank holds as many rows, so each local mean has weight 1/dp),
    under the active shard (or over `group`); `local_mean` itself with
    neither."""
    group = group if group is not None else dp_group()
    if group is None:
        return local_mean
    return all_sum(local_mean / dist.get_world_size(group), group)


def sync_grads(grads: Iterable[Optional[torch.Tensor]]) -> None:
    """Average the gradients in place over the active shard's group (one
    collective over their concatenation); nothing without a shard."""
    shard = _ACTIVE.get()
    if shard is None:
        return
    grads = [g for g in grads if g is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=shard.group)
    flat /= shard.count
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
