"""`program_spans` and the five readers of the program's spans on a
synthetic record: a profiled unit of 1,000 ns with known device operations
and program spans, whose idle stretches, copies and host times were put
down by hand; and None wherever the program recorded nothing."""
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from emloco_tpu_torch.utils import profiling  # noqa: E402
from port_bench import core, program_spans  # noqa: E402

# (name, start ns, end ns, parent); the last two lie outside the unit or
# are still open, and are left out
TRAIN_SPANS = [
    ("trainer.rollout", 0, 400, None),
    ("env.step", 50, 150, 0),
    ("physics.step", 60, 120, 1),
    ("env.step", 200, 300, 0),
    ("policy.actor", 310, 330, 0),
    ("trainer.update", 450, 950, None),
    ("trainer.optimizer", 500, 600, 5),
    ("trainer.optimizer", 700, 800, 5),
    ("trainer.prepare", 960, None, None),
    ("env.step", 1200, 1300, None),
]
# (name, start ns, length ns): busy [0, 60] [100, 110] [140, 220]
# [250, 255] [260, 265] [400, 520] [600, 605] [650, 750] [900, 1000]
TRAIN_OPS = [
    ("k1", 0, 60),
    ("Memcpy HtoD (Pageable -> Device)", 100, 10),
    ("k2", 140, 80),
    ("Memcpy DtoH (Device -> Pageable)", 250, 5),
    ("Memcpy DtoD (Device -> Device)", 260, 5),
    ("k3", 400, 120),
    ("Memcpy HtoD (Pageable -> Device)", 600, 5),
    ("k4", 650, 100),
    ("k5", 900, 100),
]
# idle ns by the innermost span open on the host
TRAIN_IDLE = {"physics.step": 50, "env.step": 90, "policy.actor": 20,
              "trainer.rollout": 80, "trainer.optimizer": 130,
              "trainer.update": 145}
PREDICTOR_SPANS = [
    ("predictor.step", 0, 400, None),
    ("predictor.optimizer", 300, 380, 0),
    ("predictor.step", 500, 900, None),
    ("predictor.optimizer", 800, 860, 2),
]
NEW = ("step_idle_ms.env", "copies_per_step.env", "optimizer_ms.train",
       "optimizer_idle_ms.train", "optimizer_ms.predictor")


def record(ops, units=1, window_s=500e-9, counts=None, profile=True):
    """A 1,000-ns profiled unit that the profiler stretched twofold (the
    window's mean unit, times the units profiled, is 500 ns)."""
    prof = core.Profile(ops=list(ops), spans=[], start_ns=0, end_ns=1000)
    return core.Record(setup_s=1.0, window_s=window_s, units=units,
                       work_per_unit={}, flops_per_unit=0.0,
                       spans=core.Spans(False, torch.device("cpu")),
                       profile=prof if profile else None,
                       counts=dict(counts or {}))


def read(name, rec):
    return core.load_module("metrics", name).read(rec)


@pytest.fixture
def spans(monkeypatch):
    def use(recs):
        monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return use


def test_spans_inside_the_unit_and_the_stretch(spans):
    spans(TRAIN_SPANS)
    rec = record(TRAIN_OPS)
    assert program_spans.records(rec) == TRAIN_SPANS[:8]
    assert program_spans.stretch(rec) == pytest.approx(2.0, rel=1e-12)
    two = record(TRAIN_OPS, units=4, window_s=1000e-9,
                 counts={"profiled_units": 2})
    assert program_spans.stretch(two) == pytest.approx(2.0, rel=1e-12)


def test_unprofiled_idle_sums_to_the_windows(spans):
    spans(TRAIN_SPANS)
    rec = record(TRAIN_OPS)
    by = program_spans.by_span(rec, program_spans.records(rec))
    assert {k: v[1] for k, v in by.items() if v[1]} == TRAIN_IDLE
    assert by["env.step"] == [140, 90] and by["physics.step"] == [60, 50]
    assert sum(v[0] for v in by.values()) == 1000
    # each span's host ns over the stretch 2, less the device's busy ns,
    # before the floor at 0, sum to the window's unit (500 ns) less the
    # device's busy ns (485)
    assert sum(h / 2 - (h - i) for h, i in by.values()) == 15
    assert program_spans.unprofiled_idle(220, 160, 2.0) == 50
    assert program_spans.unprofiled_idle(100, 10, 2.0) == 0.0


def test_idle_is_put_down_to_the_innermost_span(spans):
    spans(TRAIN_SPANS)
    rec = record(TRAIN_OPS)
    assert program_spans.idle_intervals(rec.profile) == [
        (60, 100), (110, 140), (220, 250), (255, 260), (265, 400),
        (520, 600), (605, 650), (750, 900)]
    by = program_spans.by_span(rec, program_spans.records(rec))
    assert {k: v[1] for k, v in by.items() if v[1]} == TRAIN_IDLE
    assert program_spans.idle_within(rec, TRAIN_SPANS[:8],
                                     "trainer.update") == 45 + 130 + 100


def test_outside_every_span_is_none():
    segs = program_spans.innermost([("a", 10, 20, None),
                                    ("b", 12, 15, 0)], 0, 30)
    assert segs == [(0, 10, None), (10, 12, "a"), (12, 15, "b"),
                    (15, 20, "a"), (20, 30, None)]


def test_the_readers_on_known_spans(spans):
    spans(TRAIN_SPANS)
    rec = record(TRAIN_OPS)
    # physics, env and policy innermost 220 host ns, 160 of them idle:
    # 220 / 2 - 60 busy = 50 ns over 2 steps
    assert read("step_idle_ms.env", rec) == pytest.approx(25e-6, rel=1e-12)
    # a HtoD and a DtoH inside the steps; the DtoD and the HtoD in the
    # optimizer left out; not rescaled
    assert read("copies_per_step.env", rec) == 1.0
    # 200 host ns over 2 minibatches, stretch 2
    assert read("optimizer_ms.train", rec) == pytest.approx(50e-6,
                                                            rel=1e-12)
    # 200 host ns, 130 of them idle: 200 / 2 - 70 busy = 30 ns over 2
    # minibatches
    assert read("optimizer_idle_ms.train", rec) == pytest.approx(
        15e-6, rel=1e-12)
    # a stretch of 10: the device's busy time exceeds the host's, so 0
    assert read("optimizer_idle_ms.train",
                record(TRAIN_OPS, window_s=100e-9)) == 0.0
    assert read("optimizer_ms.predictor", rec) is None
    spans(PREDICTOR_SPANS)
    steps = record([("k", 0, 10)], units=4, window_s=1000e-9,
                   counts={"profiled_units": 2})
    # (80 + 60) host ns over 2 steps, stretch 2
    assert read("optimizer_ms.predictor", steps) == pytest.approx(
        35e-6, rel=1e-12)
    assert read("step_idle_ms.env", steps) is None


@pytest.mark.parametrize("metric", NEW)
def test_none_when_the_program_recorded_nothing(spans, monkeypatch, metric):
    spans([])
    assert read(metric, record(TRAIN_OPS)) is None
    spans(TRAIN_SPANS + PREDICTOR_SPANS)
    assert read(metric, record(TRAIN_OPS, profile=False)) is None
    assert read(metric, record([])) is None
    # a program without the spans (its profiling module has no records)
    monkeypatch.delattr(profiling, "records")
    assert read(metric, record(TRAIN_OPS)) is None


def test_idle_by_span_reads_a_tiny_cell(tiny):
    """`idle_by_span.py` on the CPU: the unit times, the synchronized
    optimizer step, and the program's spans by innermost span (the CPU
    profile has no device operation, so the five metrics read None)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    p = subprocess.run(
        [sys.executable, os.path.join(tiny, "port_bench", "idle_by_span.py"),
         "--workload", "tiny_pacer_terrain.train", "--seed", str(2**31 + 5),
         "--pairs", "1"],
        capture_output=True, text=True, timeout=600, cwd=tiny, env=env)
    assert p.returncode == 0, p.stderr[-4000:]
    line = p.stdout.strip().splitlines()[-1]
    assert line.startswith("IDLE_BY_SPAN ")
    out = json.loads(line[len("IDLE_BY_SPAN "):])
    assert len(out["unit_s_off"]) == len(out["unit_s_on"]) == 1
    # tiny: mini_epochs 1 x num_minibatches 2
    assert out["apply_grads_sync_ms"]["n"] == 2
    counts = out["spans_per_unit"]
    assert counts["env.step"] == counts["physics.step"] == 4
    assert counts["trainer.optimizer"] == 2
    assert all(out[m] is None for m in NEW)
    rows = {r[0]: r[1:] for r in out["by_innermost_span"]}
    assert "trainer.optimizer" in rows and "physics.factor" in rows
    assert out["idle_share_in_spans"] > 0.9
    assert out["emloco_device_ops"] == 0
