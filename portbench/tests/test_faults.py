"""A run of each cell on the CPU, the look for a card skipped: correct when
the program is sound, not correct under each fault the cell can have."""

import pytest

from conftest import tiny_cell
from portbench import common, faults, run

CELLS = [w["name"] for w in common.manifest()["workloads"]]


@pytest.mark.parametrize("fault", [None, *sorted(faults.FAULTS)])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault):
    cell, traffic, config = tiny_cell(name)
    with faults.planted(fault):
        r = run.run_cell(name, cell, traffic, config, 2**40 + 11, 0.2, False, "cpu",
                         common.manifest())
    assert r["correct"] == (fault is None), (fault, r["numbers"])
    assert list(r["checks"]) == list(traffic["limits"])
    if fault is None:
        end_to_end = set(r["metrics"])
        assert {m["name"] for m in common.metrics_of(name, "end_to_end")} == end_to_end


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_the_cpu(name):
    """The traced path runs; with no device trace the device readers give
    nothing, and the counters' readers still read."""
    cell, traffic, config = tiny_cell(name)
    r = run.run_cell(name, cell, traffic, config, 7, 0.2, True, "cpu", common.manifest())
    assert r["correct"]
    assert not any(k.startswith(("b1_", "b2_", "idle")) for k in r["metrics"])
