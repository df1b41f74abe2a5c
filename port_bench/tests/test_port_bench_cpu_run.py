"""Each driver run end to end on the CPU at a tiny size in a copy of the
folder (the harness's look for a card skipped): the plain reference agrees
with the port, and with the timed path broken underneath (a step that
returns its state unchanged; half of the batch left out, the mean taken
over the rest; in the pacer cells, a physics substep dropped) `correct`
comes out false."""
import pytest

from conftest import CELLS, run_tiny


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(tiny, cell):
    out = run_tiny(tiny, "tiny_" + cell)["result"]
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_layers(tiny, cell):
    out = run_tiny(tiny, "tiny_" + cell, trace=True)["result"]
    assert out["correct"], out["checks"]
    names = set(out["metrics"])
    mfu = "mfu.predictor" if cell.startswith("transmotion") else "mfu.env"
    assert mfu in names and 0 < out["metrics"][mfu]["value"] <= 100
    assert "breakdown" in out and "window_s" in out["device"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_caught(tiny, cell, fault):
    out = run_tiny(tiny, "tiny_" + cell, fault=fault)["result"]
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("pacer")])
def test_a_dropped_substep_is_caught(tiny, cell):
    out = run_tiny(tiny, "tiny_" + cell, fault="skip_substep")["result"]
    assert not out["correct"], out["checks"]
    assert out["checks"]["state_gap"]["value"] > \
        out["checks"]["state_gap"]["limit"]
