"""The comparison finds the control of every cell not correct, and finds a
sound run of the same cell correct (at a size a CPU test holds; the
control's runs at the cells' own size are made on the card with
port_bench/control.py)."""

import pytest

from port_bench import control
from port_bench.tests.conftest import run_small, small_cell

# the benchmark's cells, and the rtr entry's range-aided path (conftest)
CELLS = ["grid3d.certify", "grid3d.tiles", "ra_lanes.tiles",
         "ra_lanes.edge"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = run_small(workload)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = small_cell(workload)
    with control.control_of(cell):
        out = run_small(workload, cell=cell)
    assert not out["correct"], out["checks"]
