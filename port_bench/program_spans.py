"""The program's own spans in the profiled unit, joined with the trace.

The port records a span at each layer boundary while a torch.profiler
session is active (`emloco_tpu_torch.utils.profiling.annotate`): (name,
start ns, end ns, parent) on the clock of the profiler's events, so the
spans and the unit's device operations (`core.Profile`) share one clock.
This module takes the spans that lie inside the profiled unit and puts
each stretch of device idle time down to the innermost span open on the
host then. The profiler slows the host and leaves the device's work as it
is. So a host time is rescaled by the profiler's stretch (the profiled
unit's wall time over the window's mean unit time, times the units
profiled), and the idle time under a span is its rescaled host time less
the device's busy time under it: summed over the unit, that is the
window's mean unit time less the device's busy time, exactly.

A reader returns None where the program recorded no span (a program
without them) or the profile holds no device operation.
"""
from __future__ import annotations

# the spans of a control step's layers, for the step's idle time
STEP_LAYERS = ("policy.", "env.", "physics.")
COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def records(rec) -> list | None:
    """The program's finished spans inside the profiled unit, in the order
    they opened; None where there are none."""
    p = rec.profile
    if p is None:
        return None
    try:
        from emloco_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    if read is None:
        return None
    out = [r for r in read() if r[2] is not None
           and p.start_ns <= r[1] and r[2] <= p.end_ns]
    return out or None


def stretch(rec) -> float:
    """The profiled unit's wall time over the time the window took for as
    many units."""
    n = rec.counts.get("profiled_units", 1)
    return rec.profile.wall_s / (rec.window_s / rec.units * n)


def unprofiled_idle(host: float, idle: float, s: float) -> float:
    """The device-idle time under host time `host` of the profiled unit,
    of which the device idled `idle`, without the profiler: the host time
    over the stretch `s`, less the device's busy time (unstretched), and
    not below 0 (where the device was busy throughout, its work spilled
    past the host's time)."""
    return max(host / s - (host - idle), 0.0)


def idle_intervals(profile) -> list:
    """The unit's stretches with no device operation, [start, end) ns."""
    out, t = [], profile.start_ns
    for a, b in profile.busy_intervals():
        a, b = max(a, profile.start_ns), min(b, profile.end_ns)
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if profile.end_ns > t:
        out.append((t, profile.end_ns))
    return out


def innermost(recs, start_ns: int, end_ns: int) -> list:
    """[start, end) ns from `start_ns` to `end_ns` cut where the innermost
    open span changes: (start, end, name or None outside every span)."""
    out, stack, t = [], [], start_ns

    def upto(x):
        nonlocal t
        if x > t:
            out.append((t, x, stack[-1][1] if stack else None))
            t = x
    for name, s, e, _ in sorted(recs, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][0] <= s:
            upto(stack[-1][0])
            stack.pop()
        upto(s)
        stack.append((e, name))
    while stack:
        upto(stack[-1][0])
        stack.pop()
    upto(end_ns)
    return out


def _overlaps(a: list, b: list):
    """(index into b, overlap ns) of each overlap of two sorted lists of
    disjoint [start, end) intervals."""
    i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            yield j, hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1


def by_span(rec, recs) -> dict:
    """[host ns, device-idle ns] of the profiled unit by the innermost
    program span open on the host (None: no span open), not rescaled."""
    p = rec.profile
    segs = innermost(recs, p.start_ns, p.end_ns)
    out: dict = {}
    for s, e, name in segs:
        out.setdefault(name, [0, 0])[0] += e - s
    for j, ns in _overlaps(idle_intervals(p), segs):
        out[segs[j][2]][1] += ns
    return out


def idle_within(rec, recs, name: str) -> int:
    """Device-idle ns of the profiled unit while a span `name` is open."""
    spans = sorted((s, e) for n, s, e, _ in recs if n == name)
    return sum(ns for _, ns in _overlaps(idle_intervals(rec.profile),
                                         spans))


def count(recs, name: str) -> int:
    return sum(1 for r in recs if r[0] == name)


def host_ns(recs, name: str) -> int:
    return sum(e - s for n, s, e, _ in recs if n == name)


def _joinable(rec):
    """The spans, where there are spans and device operations to join."""
    recs = records(rec)
    if recs is None or not rec.profile.ops or not rec.units:
        return None
    return recs


def step_idle_ms(rec) -> float | None:
    """Device-idle ms per control step while the host's innermost span is
    one of the step's layers (policy, env, physics), rescaled."""
    recs = _joinable(rec)
    if recs is None or not count(recs, "env.step"):
        return None
    host = idle = 0
    for name, (h, i) in by_span(rec, recs).items():
        if name is not None and name.startswith(STEP_LAYERS):
            host, idle = host + h, idle + i
    return unprofiled_idle(host, idle, stretch(rec)) * 1e-6 \
        / count(recs, "env.step")


def copies_per_step(rec) -> float | None:
    """Host-device copies (`Memcpy HtoD`, `Memcpy DtoH`) that start on the
    device inside an `env.step` span, per control step: a count, not
    rescaled. A copy from or to pageable memory holds the host until it
    is done, so it runs inside the span that made it."""
    recs = _joinable(rec)
    if recs is None or not count(recs, "env.step"):
        return None
    steps = [(s, e) for n, s, e, _ in recs if n == "env.step"]
    hits = sum(1 for name, t, _ in rec.profile.ops
               if name.startswith(COPIES) and any(s <= t < e
                                                  for s, e in steps))
    return hits / len(steps)


def span_ms(rec, name: str, per: str) -> float | None:
    """Host ms in spans `name` per span `per`, rescaled."""
    recs = _joinable(rec)
    if recs is None or not count(recs, per):
        return None
    return host_ns(recs, name) * 1e-6 / count(recs, per) / stretch(rec)


def idle_ms(rec, name: str, per: str) -> float | None:
    """Device-idle ms while a span `name` is open per span `per`,
    rescaled."""
    recs = _joinable(rec)
    if recs is None or not count(recs, per):
        return None
    return unprofiled_idle(host_ns(recs, name), idle_within(rec, recs, name),
                           stretch(rec)) * 1e-6 / count(recs, per)
