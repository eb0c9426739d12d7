"""Spawn the ranks of a process group on one host, as a launcher would, and
collect what each returns.

    results = run_ranks(fn, world, *args)

starts `world` processes (`torch.multiprocessing`, start method spawn),
each with the environment `torchrun` gives a rank (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR=localhost, MASTER_PORT a free
port), calls `fn(rank, *args)` there and pickles its result. `fn` joins the
group itself (`mesh.initialize_distributed`); the group is destroyed after
it returns. `fn` must be importable by name (a module-level function). A
rank that raises makes `run_ranks` raise with that rank's traceback (the
other ranks are stopped); nothing is swallowed. Ranks still running after
`timeout` seconds are killed and `run_ranks` raises.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
from typing import Callable, List


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, fn: Callable, world: int, port: int, out_dir: str,
           args: tuple) -> None:
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        result = fn(rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, world: int, *args,
              timeout: float = 900.0) -> List:
    """-> [fn's result on rank 0, ..., on rank world - 1]. Raises
    TimeoutError, the ranks killed, when they have not all ended within
    `timeout` seconds (a rank waiting on a collective no peer joins)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.spawn(_entry, args=(fn, world, free_port(), out_dir, args),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout:.0f} s")
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
