"""Where one cell's device waits, by the program's own spans.

    python3 port_bench/idle_by_span.py --workload <cell> --seed <n>
        [--pairs 5]

Sets the cell up as `run.py` does, then:
- runs `--pairs` pairs of units with the program's spans recording
  (`profiling.recording()`) and off, alternating which goes first: the
  recording cost;
- in a cell whose driver holds an `AMPAgent`, one unit with
  `_apply_grads` synchronized at both ends (its host time, unprofiled)
  and, on the card, one with the stream held by a sleep while
  `_apply_grads` launches, so that its kernels then run back to back
  between two events (their device time, unprofiled);
- one unit under torch.profiler, as a `--trace 1` run profiles it, read by
  `program_spans`.

Prints one JSON line, `IDLE_BY_SPAN {...}`: the card, the unit times, the
metrics of the program's spans, the share of the device's idle time under
a program span, and per innermost span its host and device-idle ms a
unit, as profiled and rescaled (`program_spans.unprofiled_idle`), the
spans' counts a unit and the host-device copies by innermost span. Runs on the CPU too, without the card's readings.
"""
import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(_ROOT, "build", "port_bench", _sub)
    os.makedirs(os.environ[_var], exist_ok=True)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

METRICS = ("step_idle_ms.env", "copies_per_step.env", "optimizer_ms.train",
           "optimizer_idle_ms.train", "optimizer_ms.predictor")
# cycles of `torch.cuda._sleep` that hold the stream while the host
# launches one optimizer step (about 50 ms at 1,980 MHz; the step's
# launch takes about 10 ms on the H100's host)
HOLD_CYCLES = 100_000_000


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=5)
    return p.parse_args(argv)


def unit_times(drv, off, dev, pairs):
    """{False: [s, ...], True: [s, ...]}: whole units with the program's
    spans off and recording, alternating which runs first."""
    from emloco_tpu_torch.utils import profiling
    from port_bench import core

    def timed(on):
        core.synchronize(dev)
        t = time.perf_counter()
        if on:
            with profiling.recording():
                drv.unit(off)
        else:
            drv.unit(off)
        core.synchronize(dev)
        return time.perf_counter() - t
    times = {False: [], True: []}
    for k in range(pairs):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            times[on].append(timed(on))
    return times


def apply_grads_readings(drv, off, dev) -> dict:
    """AMPAgent._apply_grads without the profiler: its host ms with the
    device drained before and after, and on the card its kernels' device
    ms, run back to back behind a sleep that outlasts their launch."""
    import torch

    from port_bench import core
    agent = drv.agent
    orig = agent._apply_grads
    out = {}

    def mean(xs):
        return dict(n=len(xs), mean=statistics.mean(xs),
                    median=statistics.median(xs))

    host = []

    def synced(*a, **kw):
        core.synchronize(dev)
        t = time.perf_counter()
        r = orig(*a, **kw)
        core.synchronize(dev)
        host.append((time.perf_counter() - t) * 1e3)
        return r
    agent._apply_grads = synced
    try:
        drv.unit(off)
    finally:
        del agent._apply_grads
    if not host:                       # a unit with no optimizer step
        return out
    out["apply_grads_sync_ms"] = mean(host)
    if dev.type != "cuda":
        return out

    busy = []

    def queued(*a, **kw):
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        e0.record()
        r = orig(*a, **kw)
        held = not e0.query()          # the stream still held: no gap
        e1.record()
        torch.cuda.synchronize(dev)
        busy.append(e0.elapsed_time(e1) if held else float("nan"))
        return r
    agent._apply_grads = queued
    try:
        drv.unit(off)
    finally:
        del agent._apply_grads
    out["apply_grads_device_ms"] = mean([b for b in busy if b == b])
    out["apply_grads_device_ms"]["released_early"] = sum(b != b for b in busy)
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from emloco_tpu_torch.utils import profiling
    from port_bench import core, program_spans

    dev = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    wl = core.load_json("workloads", args.workload)
    drv = core.load_module("drivers", wl["driver"]).Driver()
    off = core.Spans(False, dev)
    drv.setup(core.Context(cell=args.workload, workload=wl,
                           config=core.load_json("configs", wl["config"]),
                           seed=args.seed, device=dev, spans=off))
    for _ in range(2):
        drv.unit(off)
    core.synchronize(dev)
    times = unit_times(drv, off, dev, args.pairs)
    out = {"cell": args.workload, "seed": args.seed,
           "card": core.nvidia_smi() if dev.type == "cuda" else "cpu",
           "torch": torch.__version__,
           "unit_s_off": times[False], "unit_s_on": times[True],
           "recording_cost": statistics.mean(times[True])
           / statistics.mean(times[False]) - 1}
    if getattr(drv, "agent", None) is not None:
        out.update(apply_grads_readings(drv, off, dev))

    prof = core.profile_unit(
        lambda: drv.profiled_unit(core.Spans(True, dev)), dev)
    rec = core.Record(setup_s=0.0, window_s=sum(times[False]),
                      units=len(times[False]), work_per_unit={},
                      flops_per_unit=0.0, spans=off, profile=prof,
                      counts=drv.counts())
    for name in METRICS:
        out[name] = core.load_module("metrics", name).read(rec)
    recs = program_spans.records(rec) or []
    n = rec.counts.get("profiled_units", 1)
    s = program_spans.stretch(rec)
    by = program_spans.by_span(rec, recs)
    idle = sum(i for _, i in by.values())
    busy_ns = prof.end_ns - prof.start_ns - idle
    out.update(stretch=s, profiled_wall_s=prof.wall_s, busy_s=prof.busy_s(),
               idle_ms_per_unit=idle * 1e-6 / n,
               unprofiled_idle_ms_per_unit=(
                   (prof.end_ns - prof.start_ns) / s - busy_ns) * 1e-6 / n,
               idle_share_in_spans=1 - by.get(None, (0, 0))[1] / idle
               if idle else None)
    if recs and "trainer.optimizer" in {r[0] for r in recs}:
        h = program_spans.host_ns(recs, "trainer.optimizer")
        b = h - program_spans.idle_within(rec, recs, "trainer.optimizer")
        out["optimizer_busy_ms_profiled"] = b * 1e-6 / program_spans.count(
            recs, "trainer.optimizer")
    rows = sorted(by.items(), key=lambda kv: -kv[1][1])
    # [span, host ms, idle ms, rescaled idle ms] a unit
    out["by_innermost_span"] = [
        [str(k), h * 1e-6 / n, i * 1e-6 / n,
         program_spans.unprofiled_idle(h, i, s) * 1e-6 / n]
        for k, (h, i) in rows]
    counts = {}
    for r in recs:
        counts[r[0]] = counts.get(r[0], 0) + 1
    out["spans_per_unit"] = {k: v / n for k, v in sorted(counts.items())}
    segs = program_spans.innermost(recs, prof.start_ns, prof.end_ns)
    starts = sorted((t, t + 1) for name, t, _ in prof.ops
                    if name.startswith(program_spans.COPIES))
    copies = {}
    for j, _ in program_spans._overlaps(starts, segs):
        copies[str(segs[j][2])] = copies.get(str(segs[j][2]), 0) + 1
    out["copies_by_innermost_span"] = {
        k: v / n for k, v in sorted(copies.items(), key=lambda kv: -kv[1])}
    # a span's range copied onto the device's timeline would read as work
    out["emloco_device_ops"] = sum(1 for name, _, _ in prof.ops
                                   if name.startswith(profiling.PREFIX))

    def per_span_ns(reps=100_000):
        t = time.perf_counter_ns()
        for _ in range(reps):
            with profiling.annotate("x"):
                pass
        return (time.perf_counter_ns() - t) / reps
    out["span_ns_off"] = per_span_ns()
    with profiling.recording():
        out["span_ns_on"] = per_span_ns()
    out["total_s"] = time.perf_counter() - _T_START
    print("IDLE_BY_SPAN " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
