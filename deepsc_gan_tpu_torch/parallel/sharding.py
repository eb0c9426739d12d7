"""Data-parallel training steps and SNR-sharded sweeps over a `Mesh`
(JAX package `parallel/sharding.py`).

Training: every rank holds the whole model and the same GLOBAL batch (each
loads it from the same seeded data set) and computes on its rows. A
parallel step runs the port's single-process step inside
`batch.sharded(...)`: the channel draws and dropout masks are the global
batch's rows for the rank (a generator seeded alike on every rank), the
batch-wide statistics and the loss means are the global batch's, and the
gradients are averaged over the dp group before clipping, Adam and the EMA
(`parallel/batch.py`). Every rank ends the step with the same state, which
`replicate` makes so at the start (a broadcast from the group's first
rank). The JAX dp step is one program over the gathered batch (GSPMD); this
one equals the single-process step up to the order of its sums (the
gradients of two half-batches are summed, not one batch's).

Sweeps: each rank of an snr group decodes its block of the SNR points over
the whole batch, with the noise the single-process sweep draws for them
(the caller draws the (S, ...) noise as before and every rank keeps its
block), and the blocks are gathered to every rank in order, so the scoring
(`evaluate/evaluator.py:snr_sweep_bleu_fast`) is the single-process one.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from deepsc_gan_tpu_torch.evaluate.beam import make_beam_decode_sweep
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_sweep
from deepsc_gan_tpu_torch.evaluate.kv_decode import (
    make_greedy_decode_kv_sweep,
)
from deepsc_gan_tpu_torch.ops.losses import loss_function
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.parallel.batch import Shard, own_rows, sharded
from deepsc_gan_tpu_torch.parallel.mesh import Mesh
from deepsc_gan_tpu_torch.train.gan_steps import make_gan_train_step
from deepsc_gan_tpu_torch.train.mine_steps import make_mine_train_step
from deepsc_gan_tpu_torch.train.steps import (
    _loss_kwargs,
    _shift_targets,
    make_train_attack_step,
    make_train_step,
)
from deepsc_gan_tpu_torch.utils.config import Config


def dp_shard(mesh: Mesh) -> Optional[Shard]:
    """This rank's shard of the mesh's dp axis (None without a group)."""
    if mesh.dp_group is None:
        return None
    return Shard(mesh.dp_group, mesh.dp_index, mesh.dp)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (the whole batch without a
    group)."""
    return own_rows(batch, 0, dp_shard(mesh))


@torch.no_grad()
def replicate(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Every parameter and buffer of `module` broadcast from the dp group's
    first rank, in place; -> module."""
    if mesh.dp_group is not None:
        src = dist.get_global_rank(mesh.dp_group, 0)
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=mesh.dp_group)
    return module


def _check_bs(cfg: Config, mesh: Mesh) -> None:
    if cfg.bs % mesh.dp:
        raise ValueError(f"batch size {cfg.bs} not divisible by "
                         f"dp={mesh.dp}")


def _fade_rows(fade, cfg: Config, shard):
    """A fade's rows for the rank: per-row fades are split, one per call
    is shared."""
    return own_rows(fade, 0, shard) if cfg.fading_per_sample else fade


def make_parallel_train_step(model: nn.Module, cfg: Config, mesh: Mesh,
                             full_target: bool = False,
                             plain: bool = False) -> Callable:
    """Data-parallel `train.steps.make_train_step`: -> `step(state, inp,
    tar, gen, n_std, noise=None, fade=None) -> (state, loss)` with the
    GLOBAL batch and draws (when given), the rank's rows taken here; the
    loss is the global batch's."""
    _check_bs(cfg, mesh)
    step = make_train_step(model, cfg, plain=plain, full_target=full_target)
    shard = dp_shard(mesh)

    def par(state, inp, tar, gen, n_std, noise=None, fade=None):
        with sharded(shard):
            return step(state, own_rows(inp, 0, shard),
                        own_rows(tar, 0, shard), gen, n_std,
                        own_rows(noise, 0, shard),
                        _fade_rows(fade, cfg, shard))

    return par


def make_parallel_attack_step(model: nn.Module, cfg: Config, mesh: Mesh,
                              full_target: bool = False,
                              adv_weight: float = 1.0,
                              plain: bool = False) -> Callable:
    """Data-parallel FGM step (`make_train_attack_step`): -> `step(state,
    inp, tar, gen, pnr_db, n_std, epsilon, noise1=None, noise2=None,
    fade1=None, fade2=None) -> (state, (clean_loss, adv_loss))`, global
    batch and draws; the FGM's global norm is the global batch's."""
    _check_bs(cfg, mesh)
    step = make_train_attack_step(model, cfg, full_target, adv_weight, plain)
    shard = dp_shard(mesh)

    def par(state, inp, tar, gen, pnr_db, n_std, epsilon, noise1=None,
            noise2=None, fade1=None, fade2=None):
        with sharded(shard):
            return step(state, own_rows(inp, 0, shard),
                        own_rows(tar, 0, shard), gen, pnr_db, n_std, epsilon,
                        own_rows(noise1, 0, shard),
                        own_rows(noise2, 0, shard),
                        _fade_rows(fade1, cfg, shard),
                        _fade_rows(fade2, cfg, shard))

    return par


def make_parallel_gan_step(model: nn.Module, cfg: Config, mesh: Mesh,
                           full_target: bool = False,
                           plain: bool = False) -> Callable:
    """Data-parallel GAN three-phase step (`make_gan_train_step`): ->
    `step(state, inp, tar, gen, n_std, noise_p=None, noise_r=None,
    fade_p=None, fade_r=None) -> (state, (loss, g_loss, d_loss))`, global
    batch and draws; each of the three updates takes gradients averaged
    over the group."""
    _check_bs(cfg, mesh)
    step = make_gan_train_step(model, cfg, full_target, plain)
    shard = dp_shard(mesh)

    def par(state, inp, tar, gen, n_std, noise_p=None, noise_r=None,
            fade_p=None, fade_r=None):
        with sharded(shard):
            return step(state, own_rows(inp, 0, shard),
                        own_rows(tar, 0, shard), gen, n_std,
                        own_rows(noise_p, 0, shard),
                        own_rows(noise_r, 0, shard),
                        _fade_rows(fade_p, cfg, shard),
                        _fade_rows(fade_r, cfg, shard))

    return par


def make_parallel_mine_step(model: nn.Module, mine: nn.Module, cfg: Config,
                            mesh: Mesh) -> Callable:
    """Data-parallel MINE step (`make_mine_train_step`): -> `step(state,
    mine_state, inp, tar, gen, n_std, noise=None, perm=None, fade=None) ->
    (state, mine_state, (ce, mi))`, global batch and draws; `perm` is the
    global batch's permutation, and the bound is the global batch's."""
    _check_bs(cfg, mesh)
    step = make_mine_train_step(model, mine, cfg)
    shard = dp_shard(mesh)

    def par(state, mine_state, inp, tar, gen, n_std, noise=None, perm=None,
            fade=None):
        with sharded(shard):
            return step(state, mine_state, own_rows(inp, 0, shard),
                        own_rows(tar, 0, shard), gen, n_std,
                        own_rows(noise, 0, shard), perm,
                        _fade_rows(fade, cfg, shard))

    return par


def _snr_block(mesh: Mesh, points: int) -> slice:
    if points % mesh.snr:
        raise ValueError(f"{points} SNR points do not split over "
                         f"snr={mesh.snr}")
    n = points // mesh.snr
    return slice(mesh.snr_index * n, (mesh.snr_index + 1) * n)


def gather_blocks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The snr group's blocks of a sweep's output, in order, on every
    rank."""
    if mesh.snr_group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.snr)]
    dist.all_gather(parts, x, group=mesh.snr_group)
    return torch.cat(parts)


def sharded_sweep(sweep: Callable, mesh: Mesh) -> Callable:
    """A noise-level sweep `sweep(inp, pnr_db, n_stds[S], noise[S, ...],
    fade=None) -> (S, ...)` with S split over the mesh's snr axis: each
    rank runs its block of the levels (and of their noise and fades) and
    the blocks are gathered to every rank."""

    def par(inp, pnr_db, n_stds, noise, fade=None):
        blk = _snr_block(mesh, n_stds.shape[0])
        out = sweep(inp, pnr_db, n_stds[blk], noise[blk],
                    None if fade is None else fade[blk])
        with torch.no_grad():
            return gather_blocks(out.clone(), mesh)

    return par


def make_parallel_greedy_sweep(model: nn.Module, cfg: Config, mesh: Mesh,
                               position_mode: str = "step") -> Callable:
    """`evaluate.greedy.make_greedy_decode_sweep` with the S axis split
    over the mesh's snr axis: -> `sweep(inp, pnr_db, n_stds[S],
    noise[S, B, L, C], fade=None) -> (S, B, max_length+1) ids`."""
    return sharded_sweep(make_greedy_decode_sweep(model, cfg, position_mode),
                         mesh)


def make_parallel_greedy_kv_sweep(model: nn.Module, cfg: Config,
                                  mesh: Mesh) -> Callable:
    """The KV-cached greedy sweep (`make_greedy_decode_kv_sweep`) with the
    S axis split over the mesh's snr axis."""
    return sharded_sweep(make_greedy_decode_kv_sweep(model, cfg), mesh)


def make_parallel_beam_sweep(model: nn.Module, cfg: Config, mesh: Mesh,
                             beam_size: int = 4, **kw) -> Callable:
    """The KV-cached beam sweep (`make_beam_decode_sweep`, `kw` its `topk`)
    with the S axis split over the mesh's snr axis."""
    return sharded_sweep(make_beam_decode_sweep(model, cfg, beam_size, **kw),
                         mesh)


def make_snr_sweep(model: nn.Module, cfg: Config,
                   full_target: bool = False) -> Callable:
    """Teacher-forced CE and token accuracy at S noise levels (the JAX
    package's `make_parallel_snr_sweep` body): -> `sweep(inp, tar,
    n_stds[S], noise[S, B, L, C], fade=None) -> (ce[S], acc[S])`,
    deterministic, the masked CE of `loss_function` on the logits and the
    accuracy of their argmax over the target's non-pad positions
    (`full_target`: the un-shifted target, the star decoders')."""
    lkw = _loss_kwargs(cfg)

    @torch.inference_mode()
    def sweep(inp, tar, n_stds, noise, fade=None):
        tar_inp, tar_shift = _shift_targets(tar)
        tar_real = tar if full_target else tar_shift
        enc_mask, combined_mask, dec_mask = create_masks(inp, tar_inp,
                                                         cfg.pad_idx)
        tx = model.encode(inp, enc_mask)
        mask = (tar_real != cfg.pad_idx).float()
        ces, accs = [], []
        for i in range(n_stds.shape[0]):
            y = model.transmit(tx, noise[i], n_stds[i],
                               fade=None if fade is None else fade[i])
            logits = model.decode(tar_inp, y, combined_mask, dec_mask)
            ces.append(loss_function(tar_real, logits, **lkw))
            hit = (torch.argmax(logits, dim=-1) == tar_real).float()
            accs.append(torch.sum(hit * mask)
                        / torch.clamp(torch.sum(mask), min=1.0))
        return torch.stack(ces), torch.stack(accs)

    return sweep


def make_parallel_snr_sweep(model: nn.Module, cfg: Config, mesh: Mesh,
                            full_target: bool = False) -> Callable:
    """`make_snr_sweep` with the S axis split over the mesh's snr axis: ->
    `sweep(inp, tar, n_stds[S], noise[S, ...], fade=None) -> (ce[S],
    acc[S])` on every rank."""
    sweep = make_snr_sweep(model, cfg, full_target)

    def par(inp, tar, n_stds, noise, fade=None):
        blk = _snr_block(mesh, n_stds.shape[0])
        ce, acc = sweep(inp, tar, n_stds[blk], noise[blk],
                        None if fade is None else fade[blk])
        both = gather_blocks(torch.stack([ce, acc], dim=1).clone(), mesh)
        return both[:, 0], both[:, 1]

    return par
