"""Profiling hooks (JAX package `utils/profiling.py`): a torch.profiler
trace around a block, written as a Chrome trace (chrome://tracing,
Perfetto) under a directory, and named regions that show up in it.
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block's host operations, and its kernels on a card when
    there is one, into `<log_dir>/trace.json`. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named region in the trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)
