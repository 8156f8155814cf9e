"""The control on the card: the plain reference in TF32 (the next precision
below the configurations' float32 with TF32 off), put in the program's
place, is not correct by the cell's limits, where the program is."""

import pytest

from portbench import common, run

CELLS = [w["name"] for w in common.manifest()["workloads"]]
SECONDS = {"droughts365-train": 20.0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(cuda, name):
    cell, traffic, config = common.cell_files(name)
    r = run.run_cell(name, cell, traffic, config, 2**33 + 1, SECONDS.get(name, 1.0), False,
                     cuda, common.manifest(), control=True)
    assert r["correct"], r["numbers"]
    ok, _ = common.check_numbers(r["control"], traffic["limits"])
    assert not ok, r["control"]
