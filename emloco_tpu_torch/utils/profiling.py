"""Profiling hooks: torch.profiler traces and timing (port of
emloco_tpu/utils/profiling.py).

`trace(log_dir)` records the CPU and CUDA activity inside it and writes a
Chrome trace (`trace.json`, viewable in perfetto or chrome://tracing) into
`log_dir`; `device_timer` gives the mean time of a call, with CUDA events
on the card and the host clock on the CPU; `annotate` names a region of the
trace.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a CPU + CUDA trace of the block into log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_timer(fn, *args, iters: int = 5, warmup: int = 1,
                 device=None):
    """Mean seconds of fn(*args) over `iters` calls after `warmup` calls:
    CUDA events on a CUDA `device`, the host clock otherwise."""
    dev = torch.device("cpu" if device is None else device)
    for _ in range(warmup):
        fn(*args)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def annotate(name: str):
    """Named region for traces (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)
