"""Profiling hooks: the program's spans and torch.profiler traces (port of
emloco_tpu/utils/profiling.py).

`annotate(name)` is the program's span: a `with` block around the work of
one layer (`env.step`, `physics.factor`, `trainer.optimizer`, ...). Spans
record only while a torch.profiler session is active or inside
`recording()`; otherwise `annotate` checks one flag and returns a shared
no-op context. Recording, a span opens the profiler range
`"emloco:" + name` and appends `(name, start_ns, end_ns, parent)` to the
session's list. The range is a CPU range of the trace, as an operator's:
a `record_function` range would also be copied onto the device's timeline
as an annotation, where a reader of the device's operations would count
it as work. `parent` is the index of the enclosing span in that list
(None at the top), and the times are read inside the range on the clock
of the profiler's events (Unix-epoch ns, `time.time_ns`), so a span lies
within its range and joins the trace's device operations on one clock. A
span never synchronizes the device: its length is host time. Each session
(a profiler session, or `recording()`) starts a new list; `records()`
returns the current or last one.

`trace(log_dir)` records the CPU and CUDA activity inside it and writes a
Chrome trace (`trace.json`, viewable in perfetto or chrome://tracing) into
`log_dir`, with the spans' `emloco:` ranges.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch._C import _profiler
from torch.autograd import profiler as _autograd_profiler

PREFIX = "emloco:"


class _Session:
    __slots__ = ("records", "open")

    def __init__(self):
        self.records: list = []
        self.open: list = []      # indices of the spans open, outermost first


_session = _Session()
_profiling = False                # a torch.profiler session is active
_recording = 0                    # depth of `recording()` blocks
_on = False                       # either: spans record
_OFF = contextlib.nullcontext()


def _set(profiling=None, recording=None, new_session=False):
    global _session, _profiling, _recording, _on
    if profiling is not None:
        _profiling = profiling
    if recording is not None:
        _recording = recording
    if new_session:
        _session = _Session()
    _on = _profiling or _recording > 0


class _Span:
    __slots__ = ("name", "session", "index", "parent", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        s = self.session = _session
        self.range = _profiler._RecordFunctionFast(PREFIX + self.name)
        self.range.__enter__()
        self.parent = s.open[-1] if s.open else None
        self.index = len(s.records)
        s.open.append(self.index)
        self.t0 = time.time_ns()
        s.records.append((self.name, self.t0, None, self.parent))
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        s = self.session
        s.open.pop()
        s.records[self.index] = (self.name, self.t0, t1, self.parent)
        self.range.__exit__(*exc)
        return False


def annotate(name: str):
    """The program's span `name` around a `with` block (see the module's
    head); off, a shared no-op context."""
    if not _on:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Spans record inside the block, into a new list, which it yields."""
    _set(recording=_recording + 1, new_session=True)
    try:
        yield _session.records
    finally:
        _set(recording=_recording - 1)


def records() -> list:
    """The spans of the current or last session: (name, start_ns, end_ns,
    parent) in the order they opened (end_ns None while open)."""
    return _session.records


def _follow_profiler_sessions(module=_autograd_profiler) -> bool:
    """Record while any torch.profiler session is active: the profiler
    calls these two functions of torch.autograd.profiler as it starts and
    stops, by their module names. Where a torch release lacks them, spans
    record only inside `recording()`; returns whether they are followed."""
    start = getattr(module, "_run_on_profiler_start", None)
    stop = getattr(module, "_run_on_profiler_stop", None)
    if not (callable(start) and callable(stop)):
        return False
    if getattr(start, "_emloco_spans", False):
        return True

    def on_start():
        start()
        _set(profiling=True, new_session=True)

    def on_stop():
        stop()
        _set(profiling=False)

    on_start._emloco_spans = True
    module._run_on_profiler_start = on_start
    module._run_on_profiler_stop = on_stop
    return True


_follow_profiler_sessions()


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
