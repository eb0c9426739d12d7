"""The process group and the layout of its ranks (JAX package
`parallel/mesh.py`).

`initialize_distributed` joins the group a launcher describes in the
environment (`torchrun` sets RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT); a single process with no
launcher stays local, as the JAX function does. Each rank computes on
`cuda:LOCAL_RANK % device_count`.

The backend, by one rule: NCCL where every rank has a card of its own (the
ranks of a host are no more than its cards); gloo where ranks share a card,
and on the CPU. NCCL refuses two ranks on one device; gloo takes CUDA
tensors for all_reduce, broadcast and all_gather, staging them through the
host.

`make_mesh(dp, snr)` lays the ranks out as an (snr, dp) grid with dp
innermost, rank = s * dp + d, and makes a group for each axis: the ranks of
one snr row share the gradient all-reduce, those of one dp column split the
SNR points of a sweep.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


def world_size() -> int:
    """The group's size: 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    """The ranks on this host (LOCAL_WORLD_SIZE, else WORLD_SIZE)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", "1")))


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK % device_count` on CUDA."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device_type: str) -> str:
    """"nccl" where every rank on this host has a card of its own, else
    "gloo" (ranks sharing a card, or the CPU)."""
    if device_type == "cuda" and torch.cuda.is_available() \
            and local_world_size() <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(device_type: str = "cuda") -> Optional[str]:
    """Join the launcher's process group (init_method env://) with the
    backend `choose_backend(device_type)` picks, and on CUDA make the
    rank's card the current one; -> the backend, or None where no launcher
    set WORLD_SIZE (a single process stays local). Idempotent: a second
    call returns the group's backend."""
    if dist.is_initialized():
        return dist.get_backend()
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    backend = choose_backend(device_type)
    kw = {}
    if device_type == "cuda":
        device = rank_device()
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device
    dist.init_process_group(backend, init_method="env://", **kw)
    return backend


@dataclass(frozen=True)
class Mesh:
    """An (snr, dp) layout of the group's ranks. `dp_group` holds this
    rank's snr row (its dp peers), `snr_group` its dp column; both None
    without a process group (a group of one rank has groups of one)."""

    snr: int
    dp: int
    snr_index: int
    dp_index: int
    dp_group: object = None
    snr_group: object = None

    @property
    def shape(self) -> dict:
        return {"snr": self.snr, "dp": self.dp}


def make_mesh(dp: Optional[int] = None, snr: int = 1) -> Mesh:
    """The (snr, dp) mesh over the group's ranks (all of them to dp when
    `dp` is None); dp * snr must equal the group's size. Every rank must
    call it, in the same order as any other group it makes."""
    n = world_size()
    if dp is None:
        dp = n // snr
    if dp * snr != n:
        raise ValueError(f"dp*snr = {dp}*{snr} != {n} ranks")
    s_idx, d_idx = divmod(rank(), dp)
    if not dist.is_initialized():
        return Mesh(snr, dp, 0, 0)
    dp_group = snr_group = None
    for s in range(snr):  # every rank makes every group, in one order
        g = dist.new_group([s * dp + d for d in range(dp)])
        if s == s_idx:
            dp_group = g
    for d in range(dp):
        g = dist.new_group([s * dp + d for s in range(snr)])
        if d == d_idx:
            snr_group = g
    return Mesh(snr, dp, s_idx, d_idx, dp_group, snr_group)
