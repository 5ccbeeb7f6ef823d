"""Profiling helpers: a torch.profiler trace and named annotations.

Counterpart of roitr_tpu/utils/profiling.py. `trace()` records the
enclosed block with torch.profiler (the host's operators, and the card's
kernels when there is a card) into a Chrome trace that TensorBoard's
profiler plugin, chrome://tracing or Perfetto open; `annotate()` marks a
named region that shows in the trace's timeline; `log_elapsed` prints a
block's wall time as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str = "profiles"):
    """Record the enclosed block into log_dir/<host>.<pid>.<ms>.pt.trace.json
    (torch.profiler's TensorBoard layout), with CUDA activity when a card
    is present. Yields log_dir."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def annotate(name: str):
    """Named region context manager visible in the trace's timeline."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def log_elapsed(label: str, printer=print):
    t0 = time.perf_counter()
    yield
    printer(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f}ms")
