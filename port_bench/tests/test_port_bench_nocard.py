"""The run refuses to measure without a CUDA card, and in a directory that
holds only BENCHMARK.json and the benchmark's folder: no result, a
non-zero exit."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT

ARGS = ["--workload", "pacer_terrain.train", "--seed", str(2**31 + 5),
        "--seconds", "1", "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "port_bench/run.py", *ARGS],
                          capture_output=True, text=True, timeout=300,
                          cwd=cwd)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = run(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
