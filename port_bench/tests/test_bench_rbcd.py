"""The rbcd entry (grid3d_r5.rbcd) at a test's size: the cell at 6^3
poses in 5 agents reads correct untraced and traced, with its per-layer
metrics; three faults planted in the program's round each read not
correct; the configuration is grid3d's graph shared by the mix's agents;
kernel 1's fleet roofline counts by hand.  On the CPU past the card
check, and the traced run once more on the card (marked cuda)."""

import json
import os
import tempfile
import time
from collections import Counter

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench import trace as tr
from port_bench.control import patched
from port_bench.tests.conftest import ROOT
from port_bench.tests.test_bench_roofline import two_poses

WORKLOAD = "grid3d_r5.rbcd"
SMALL = {"shape": [6, 6, 6]}
LAYER = {"device_idle_pct.rbcd", "exchange_ms", "update_ms", "evaluate_ms",
         "rbcd_tcg_iters", "strip_spmm_roofline"}
# what a traced run reads without a card: no kernel, no card's peaks
CPU_LAYER = LAYER - {"strip_spmm_roofline"}


def small_cell():
    c = harness.find_cell(WORKLOAD, ROOT)
    c.config = dict(c.config, params=dict(c.config["params"], **SMALL))
    return c


def run_small(trace=False, device="cpu", seed=2**31 + 77):
    with tempfile.TemporaryDirectory() as tmp:
        return harness.run_cell(small_cell(), seed, 0.3, trace, device, tmp,
                                time.perf_counter(), log=lambda s: None)


def test_cell_is_correct_untraced_and_traced():
    plain = run_small()
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"pose_iters_per_s", "setup_s"}
    assert set(plain["checks"]) == {"cost_err", "manifold_err", "shortfall",
                                    "stalled", "block_rise"}
    traced = run_small(trace=True)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == CPU_LAYER
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    assert m["rbcd_tcg_iters"] > 0
    assert m["update_ms"] > m["exchange_ms"] > 0 and m["evaluate_ms"] > 0


# -- planted faults ---------------------------------------------------------


def _frozen_exchange():
    """The exchange hands every round the buffer of its first call: the
    neighbours stay at round 0's states."""
    from dcora_tpu_torch.parallel import rbcd

    real = rbcd.ParallelRound.exchange
    first = {}

    def exchange(self, buf):
        return first.setdefault(id(self), real(self, buf))

    return rbcd.ParallelRound, "exchange", exchange


def _one_agent_idle():
    """Agent 0's block never updates: the round hands back its state."""
    from dcora_tpu_torch.core.lifted import RAState
    from dcora_tpu_torch.parallel import rbcd

    real = rbcd.ParallelRound.__call__

    def call(self, X):
        Xn, gn = real(self, X)
        keep = [x.clone() for x in Xn]
        for k, x in zip(keep, X):
            k[0] = x[0]
        return RAState(*keep), gn

    return rbcd.ParallelRound, "__call__", call


def _no_linear_term():
    """G = 0: each block is solved as if it had no neighbours."""
    from dcora_tpu_torch.core.lifted import RAState
    from dcora_tpu_torch.parallel import rbcd

    real = rbcd.ParallelRound.linear_term

    def linear_term(self, X, fixed):
        return RAState(*(torch.zeros_like(g) for g in real(self, X, fixed)))

    return rbcd.ParallelRound, "linear_term", linear_term


FAULTS = {"frozen_exchange": _frozen_exchange,
          "one_agent_idle": _one_agent_idle,
          "no_linear_term": _no_linear_term}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault):
    with patched(*FAULTS[fault]()):
        out = run_small()
    assert not out["correct"], out["checks"]


# -- the configuration and the mix -------------------------------------------


def _manifest():
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _config(name):
    c = next(c for c in _manifest()["configs"] if c["name"] == name)
    return json.load(open(os.path.join(ROOT, c["file"])))


def test_the_graph_is_grid3ds(tmp_path):
    """grid3d_r5 generates grid3d's file byte for byte."""
    files = []
    for name in ("grid3d", "grid3d_r5"):
        d = tmp_path / name
        d.mkdir()
        files.append(open(harness.make_input(_config(name), 2**31 + 11,
                                             str(d)), "rb").read())
    assert files[0] == files[1] and len(files[0]) > 0


def test_robots_are_the_mix_agents():
    cell = next(w for w in _manifest()["workloads"]
                if w["name"] == WORKLOAD)
    mix = harness.load_json(os.path.join(ROOT, "port_bench", "traffic",
                                         cell["traffic"] + ".json"))
    cfg = _config(cell["config"])
    assert cfg["robots"] == mix["agents"] == cfg["published"]["robots"]


# -- kernel 1 over the fleet --------------------------------------------------


def test_strip_spmm_counts_by_hand():
    """Two poses in two agents of one pose each: each agent's Q_aa is its
    pose's (d + 1) x (d + 1) block.  Agent 0 (Y0, t0): Y0-Y0 6 (the
    rotated kappa block dense), Y0-t0 3, t0-t0 1 in the upper triangle,
    16 in all; agent 1 (Y1, t1): kappa I 3, t1-t1 1, 4 in all."""
    least = harness._load("metrics", "strip_spmm_roofline").least_work
    g = two_poses()
    g.robots = [(0, 1), (1, 1)]
    assert least(g, 5, 4) == (4 * ((6 + 3 + 1) + (3 + 1) + 2 * 5 * 8),
                              2 * 5 * (16 + 4))


def test_strip_spmm_share_of_a_traced_window():
    read = harness._load("metrics", "strip_spmm_roofline").read
    g = two_poses()
    g.robots = [(0, 1), (1, 1)]
    dev = [(0.0, 2.0, "spmm_sym_kernel"), (5.0, 7.0, "spmm_sym_kernel")]
    peak = {"hbm": 1e9, "float32": 1e12}

    def reading(mix, peak):
        return tr.Reading(tr.Reduced(dev, []), 1.0, Counter(), [], g, 5,
                          "float32", peak, mix)

    least = (4 * (14 + 80)) / 1e9  # the bytes bound
    assert read(reading("rbcd", peak)) == pytest.approx(
        100.0 * 2 * least / 4e-6)
    assert read(reading("rtr", peak)) is None
    assert read(reading("rbcd", None)) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_small_cell_on_the_card(card):
    out = run_small(trace=True, device=card)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == LAYER
    assert 0 < out["metrics"]["strip_spmm_roofline"]["value"] <= 100
    assert np.isfinite(out["metrics"]["device_idle_pct.rbcd"]["value"])
