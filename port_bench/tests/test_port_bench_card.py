"""On the card, at each cell's own size: the control (the plain reference
in the nearest precision below the configuration's, put in the program's
place) fails the cell's limits on three seeds. Run on the card with

    python3 -m pytest port_bench/tests/test_port_bench_card.py -q
"""
import pytest
import torch

from conftest import CELLS, ROOT  # noqa: F401

SEEDS = (2**31 + 901, 2**31 + 902, 2**31 + 903)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from port_bench import calibrate, core
    limits = core.load_json("workloads", cell)["limits"]
    got = [r for r in calibrate.readings(cell, SEEDS, [], [],
                                         torch.device("cuda", 0))]
    for r in got:
        ok = core.judge(r["numbers"], limits)
        assert ok == (r["mode"] == "program"), r
