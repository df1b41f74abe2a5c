"""The harness: one cell, one run.

`run_cell` loads the cell's workload file (`workloads/<cell>.json`), its
configuration (`configs/<config>.json`) and its driver
(`drivers/<driver>.py`), all by name, and then:

  1. set-up: the driver builds the entry, makes the weights and inputs from
     the seed, and drives the first steps through the window's own call,
     keeping what the check needs (`Driver.setup`);
  2. the window: whole units (an epoch or a train step) until `seconds`
     have passed, closed loop, each unit synchronized at its end;
  3. with `trace`, one more unit under torch.profiler, read in memory;
  4. the check: the program's state is freed, and the plain reference under
     `reference/` judges what the first steps produced (`Driver.check`);
  5. the metrics: each one BENCHMARK.json lists for this cell is read by its
     own module, `metrics/<name>.py`, from the run's record (`Record`); a
     reader that finds nothing returns None and the metric is left out.

Spans are kept in memory (`Spans`); nothing is written to disk.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
SPAN_PREFIX = "bench:"
# top-level module names that no run may load: JAX, its relatives, and the
# JAX package this port was made from (compared whole: the port's own name
# begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "emloco_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` as a module; a name may hold dots."""
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The metrics of `section` that `cell` reports: those without a
    `workloads` key and those that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """The benchmark's own spans around the calls into each layer, in
    memory: (name, start, end, parent) on the host clock. Enabled, a span
    synchronizes the device at its end (so its length is the layer's) and
    names its range for the profiler; disabled, it costs nothing."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.records: list = []
        self._open: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        parent = self._open[-1] if self._open else None
        self._open.append(name)
        with torch.profiler.record_function(SPAN_PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                synchronize(self.device)
                self._open.pop()
                self.records.append((name, t0, time.perf_counter(), parent))

    def durations(self, name: str) -> list:
        return [t1 - t0 for n, t0, t1, _ in self.records if n == name]


@dataclasses.dataclass
class Profile:
    """One unit under torch.profiler: its device operations (name, start
    ns, length ns), the benchmark's spans (name, start ns, end ns) on the
    same clock, and the unit's own range."""

    ops: list
    spans: list
    start_ns: int
    end_ns: int

    @property
    def wall_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def busy_intervals(self) -> list:
        out = []
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            e = s + d
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def op_seconds(self, pattern) -> tuple:
        """(seconds, count) of the operations whose name `pattern` (a
        compiled regex) matches."""
        hits = [d for n, _, d in self.ops if pattern.search(n)]
        return sum(hits) * 1e-9, len(hits)

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for n, _, d in self.ops:
            by[n] = by.get(n, 0) + d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], d * 1e-9] for n, d in top]

    def idle_gaps(self, k: int = 10) -> list:
        """The longest stretches with no device operation inside the unit,
        each named by the innermost benchmark span open at its middle."""
        edges = [self.start_ns]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.end_ns)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) // 2
            inside = [(e - s, n) for n, s, e in self.spans if s <= mid <= e]
            out.append([min(inside)[1] if inside else "outside spans",
                        (b - a) * 1e-9])
        return out


def profile_unit(fn, device: torch.device) -> Profile:
    """Run `fn` once under torch.profiler and read its events in memory
    (no trace file)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "unit"):
            fn()
            synchronize(device)
    ops, spans, unit = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            if e.device_type() == DeviceType.CPU:
                rng = (e.start_ns(), e.start_ns() + e.duration_ns())
                if name == SPAN_PREFIX + "unit":
                    unit = rng
                else:
                    spans.append((name[len(SPAN_PREFIX):],) + rng)
            continue
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ops.append((name, e.start_ns(), e.duration_ns()))
    if unit is None:
        raise RuntimeError("the profiler recorded no range for the unit")
    return Profile(ops=ops, spans=spans, start_ns=unit[0], end_ns=unit[1])


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell's files, the seed, the device and
    the spans."""

    cell: str
    workload: dict
    config: dict
    seed: int
    device: torch.device
    spans: Spans


@dataclasses.dataclass
class Record:
    """What a run leaves for the metric readers."""

    setup_s: float
    window_s: float
    units: int
    work_per_unit: dict        # e.g. {"env_steps": 51200}
    flops_per_unit: float
    spans: Spans
    profile: Profile | None
    counts: dict               # the driver's shapes for the counts/


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def judge(numbers: dict, limits: dict) -> bool:
    """Every limit has its number, finite and at or under the limit."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= limits[k] for k in limits)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             bench: dict | None = None, fault: str | None = None) -> dict:
    """One run of `cell`; returns the result line's object (its last key,
    `checks`, holds each number compared beside its limit; `numbers`, every
    number the check read, compared or not, is taken out before it is
    printed). `fault` plants
    one of the driver's faults (the tests' check of the check)."""
    bench = benchmark() if bench is None else bench
    wl = load_json("workloads", cell)
    cfg = load_json("configs", wl["config"])
    drv = load_module("drivers", wl["driver"]).Driver()
    spans = Spans(bool(trace), device)
    ctx = Context(cell=cell, workload=wl, config=cfg, seed=int(seed),
                  device=device, spans=spans)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    drv.setup(ctx, fault=fault)
    synchronize(device)
    # what set-up made stays: no collection in the window walks it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    health, ends = [], []
    t0 = time.perf_counter()
    while True:
        health.append(drv.unit(spans))
        synchronize(device)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    units = len(ends)
    window_s = ends[-1] - t0
    failed = int((~torch.stack(health)).sum().item())
    print("window unit_s " + json.dumps(
        [b - a for a, b in zip([t0] + ends[:-1], ends)]), file=sys.stderr)

    prof = None
    if trace:
        quiet = Spans(True, device)
        prof = profile_unit(lambda: drv.profiled_unit(quiet), device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    counts = drv.counts()
    work, flops = drv.work_per_unit(), drv.flops_per_unit()
    captured = drv.release()
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = drv.check(captured)
    limits = wl["limits"]
    correct = judge(numbers, limits) and units > 0

    rec = Record(setup_s=setup_s, window_s=window_s,
                 units=units, work_per_unit=work, flops_per_unit=flops,
                 spans=spans, profile=prof, counts=counts)
    metrics = {}
    section = "per_layer" if trace else "end_to_end"
    for m in cell_metrics(bench, cell, section):
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": units, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if prof is not None:
        dev_info["busy_s"] = prof.busy_s()
        dev_info["window_s"] = prof.wall_s
        out["breakdown"] = {"device_ops": prof.top_ops(),
                            "idle_gaps": prof.idle_gaps()}
    out["numbers"] = numbers
    out["checks"] = {k: {"value": numbers.get(k, float("nan")),
                         "limit": limits[k]} for k in limits}
    return out
