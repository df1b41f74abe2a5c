"""BENCHMARK.json and the files it names: the contract's keys, names and
units; every cell, configuration, driver and metric found by name; every
metric's `moves` reported where the metric is; a cell added by files and
entries alone is found."""
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    B = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in B["end_to_end"]}


def reports(cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_and_entry_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"][1].startswith(B["paths"][0] + "/")
    assert 1 <= B["run_seconds"] <= 51
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_lines():
    names = [x["name"] for s in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[s]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in B["workloads"]]:
        assert NAME.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in B["workloads"]]
                 + [c["source"] for c in B["configs"]]
                 + [m["layer"] for m in B["per_layer"]] + B["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_files_found_by_name():
    sys.path.insert(0, ROOT)
    from port_bench import core
    for c in B["configs"]:
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        assert core.load_json("configs", c["name"])["name"] == c["name"]
    for w in B["workloads"]:
        wl = core.load_json("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert wl["why"] == w["why"]
        assert hasattr(core.load_module("drivers", wl["driver"]), "Driver")
    for m in B["end_to_end"] + B["per_layer"]:
        assert callable(core.load_module("metrics", m["name"]).read)


def test_each_cell_reports_setup_another_and_a_layer():
    for w in B["workloads"]:
        e2e = [m["name"] for m in B["end_to_end"] if reports(w["name"], m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(w["name"], m) for m in B["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_moves_is_reported_where_the_metric_is(metric):
    m = next(x for x in B["per_layer"] if x["name"] == metric)
    assert m["moves"] in E2E
    for w in B["workloads"]:
        if reports(w["name"], m):
            assert reports(w["name"], E2E[m["moves"]]), (metric, w["name"])


def test_layers_named_alike():
    layers = {m["layer"] for m in B["per_layer"]}
    for layer in layers:
        assert layer.split(" (")[0] in ("Entry", "Trainer", "LocoVal",
                                        "Kernels", "Predictor", "Device")


def test_a_cell_added_by_files_alone_is_found(tiny):
    code = (f"import sys; sys.path[:0] = [{tiny!r}, {ROOT!r}]\n"
            "from port_bench import core\n"
            "b = core.benchmark()\n"
            "wl = core.load_json('workloads', 'tiny_transmotion_jta.train')\n"
            "core.load_module('drivers', wl['driver']).Driver\n"
            "print(core.BENCH, len(core.cell_metrics(b, "
            "'tiny_transmotion_jta.train', 'per_layer')))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    where, n = p.stdout.split()
    assert where.startswith(tiny) and int(n) == 4
    assert not os.path.exists(os.path.join(
        BENCH, "workloads", "tiny_transmotion_jta.train.json"))
