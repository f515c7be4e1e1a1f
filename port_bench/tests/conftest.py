"""Shared pieces of the benchmark's own tests (run on the CPU with
``python -m pytest port_bench/tests``; they import no JAX)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells at a size a CPU test holds: the grid at 6^3 poses
SMALL = {"grid3d": {"shape": [6, 6, 6]}}

# A range-aided problem at a test's size, so that the rtr entry's
# range-aided path (the tiles and edge mixes) is driven by the tests too;
# no cell of BENCHMARK.json runs it yet.  Cells "ra_lanes.<mix>", with the
# limits below (the range-aided rtr cells' limits from their card
# calibration, held here at a test's size).
RA_CONFIG = {"name": "ra_lanes", "generator": "ra_slam_pyfg",
             "params": {"num_robots": 5, "poses_per_robot": 40,
                        "num_landmarks": 4, "range_prob": 1.0,
                        "rot_noise": 0.01, "trans_noise": 0.01,
                        "range_noise": 0.01}}
RA_LIMITS = {
    "tiles": {"cost_err": 8e-9, "stalled": 0},
    "edge": {"cost_err": 1e-19, "manifold_err": 1e-10, "shortfall": 4e-4,
             "stalled": 0},
}


@pytest.fixture(autouse=True, scope="session")
def _threads():
    torch.set_num_threads(2)


def small_cell(workload: str):
    from port_bench import harness

    config, mix = workload.split(".", 1)
    if config == RA_CONFIG["name"]:
        return harness.Cell(
            workload=workload, chips=1, config=RA_CONFIG,
            traffic=harness.load_json(os.path.join(
                ROOT, "port_bench", "traffic", mix + ".json")),
            limits={k: {"limit": v} for k, v in RA_LIMITS[mix].items()},
            end_to_end=[], per_layer=[])
    c = harness.find_cell(workload, ROOT)
    c.config = dict(c.config, params=dict(c.config["params"],
                                          **SMALL[c.config["name"]]))
    return c


def run_small(workload: str, seed: int = 987654321, seconds: float = 0.3,
              trace: bool = False, cell=None):
    import tempfile
    import time

    from port_bench import harness

    cell = cell or small_cell(workload)
    with tempfile.TemporaryDirectory() as tmp:
        return harness.run_cell(cell, seed, seconds, trace, "cpu", tmp,
                                time.perf_counter(), log=lambda s: None)
