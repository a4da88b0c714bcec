"""Profiling helpers of the PyTorch port: ``torch.profiler`` wrappers (the
port of ``pgvector_rx_tpu/utils/profiling.py``).

The reference relies on EXPLAIN ANALYZE; the lens on the device work here
is PyTorch's profiler (CUPTI on the card). ``trace(path)`` is a no-op for
``None``, so library code can always call it. Unlike the JAX package's
wrapper, an error raised by the profiler or inside the body propagates.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed work (the CPU, and the card's kernels where a
    CUDA device is visible) into ``log_dir``: a Chrome-trace JSON file per
    run (``torch.profiler.tensorboard_trace_handler``). No-op for None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    ):
        yield


def annotate(name: str):
    """A named region of the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
