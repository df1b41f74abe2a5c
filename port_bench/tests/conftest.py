"""Shared fixtures of the benchmark's CPU tests.

    python3 -m pytest port_bench/tests -q

`tiny` is a copy of the benchmark folder and BENCHMARK.json under a
temporary directory with one more workload file per cell, `tiny_<cell>`,
at a size the CPU runs in seconds; `run_tiny` runs one of them in a fresh
process on the CPU (the harness's look for a card skipped) and returns its
result and the modules it loaded.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
CELLS = ("pacer_terrain.train", "pacer_terrain.locoval",
         "transmotion_jta.train")
TINY_PACER = {"env": {"num_envs": 4},
              "amp": {"horizon": 4, "num_minibatches": 2, "mini_epochs": 1,
                      "amp_batch_size": 8, "amp_replay_size": 64},
              "value": {"horizon": 4, "step_to_pred": 2},
              "terrain": {"num_tiles": 2}}
TINY_SCENES = dict(batch=2, people=3, bank_batches=4, profiled_steps=1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: runs on the CUDA card; skips without one")


def make_copy(dst) -> str:
    """The benchmark's files under `dst`, with the tiny cells added as
    files and entries alone."""
    shutil.copytree(BENCH, os.path.join(dst, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell in CELLS:
        with open(os.path.join(BENCH, "workloads", cell + ".json")) as f:
            wl = json.load(f)
        if cell.startswith("pacer"):
            wl["traffic"]["run"] = TINY_PACER
        else:
            wl["traffic"].update(TINY_SCENES)
        with open(os.path.join(dst, "port_bench", "workloads",
                               f"tiny_{cell}.json"), "w") as f:
            json.dump(wl, f)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell in m.get("workloads", ()):
                m["workloads"].append("tiny_" + cell)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(dst)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("bench"))


_RUN = """
import json, sys, time
t0 = time.perf_counter()
sys.path[:0] = [{copy!r}, {root!r}]
import torch
torch.set_num_threads(2)
from port_bench import core
assert core.BENCH.startswith({copy!r})
out = core.run_cell({cell!r}, {seed}, 0.2, {trace}, torch.device("cpu"),
                    t0, fault={fault!r})
print(json.dumps(dict(result=out, modules=sorted(sys.modules))))
"""


def run_tiny(copy, cell, fault=None, trace=False, seed=2**31 + 77):
    code = _RUN.format(copy=copy, root=ROOT, cell=cell, seed=seed,
                       trace=trace, fault=fault)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=copy)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])
