"""drivers.parallel_pgo split into prepare() and the loop, and the
synchronous-parallel round held to the benchmark's plain block-Jacobi
reference (port_bench/reference/rbcd.py), on the CPU:

  * run() is prepare() + run_rounds + the result, bit for bit what the
    driver gave when it did all of it in one function (written out below
    as it was) on smallGrid3D with 5 agents, edge and tiled;
  * the round's linear term G of each agent's fixed states equals the
    reference's X_{-a} Q_{-a,a};
  * after one round no agent's reference block cost rises, and each
    agent's block gradient norm is the reference's at the round's output;
  * a round records its spans and counters.

The grid is the benchmark's generator at 6^3 poses with grid3d's
parameters, split among 5 agents, from the benchmark's chordal start,
float64 on the edge path.  No JAX."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dcora_tpu_torch.core import lifted, problem as prob
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import chordal_initialization
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.rtr import riemannian_gradient
from dcora_tpu_torch.drivers import parallel_pgo
from dcora_tpu_torch.drivers.multi_robot_pgo import (
    partition_measurements,
    robot_slice,
)
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.parallel import rbcd
from dcora_tpu_torch.utils import timing
from port_bench.reference import generators, graph as ref_graph, start
from port_bench.reference.problem import Problem
from port_bench.reference.rbcd import Fleet
from port_bench.reference.rtr import Budget

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENTS = 5
R = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parent_run(num_agents, g2o_path, r, max_rounds, check_every, backend,
                tile_dtype):
    """The driver's run() as it was before prepare(), one process."""
    dev = torch.device("cpu")
    ds = read_g2o_file(g2o_path)
    ms = ds.pose_pose_measurements
    d, n = ds.dim, ds.num_poses
    odo, priv, shared, _ = partition_measurements(ms, n, num_agents)
    graphs = []
    for a in range(num_agents):
        g = LocalGraph(a, r, d)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)
    T = chordal_initialization(ms, device=dev)
    X = lifted.pad_rank(lifted.from_pose_array(T, device=dev), r)
    states = []
    for a in range(num_agents):
        s, e = robot_slice(n, num_agents, a)
        states.append(RAState(rot=X.rot[s:e], sph=X.sph[:0],
                              trn=X.trn[s:e]))
    pp = rbcd.build_parallel_problem(graphs)
    rnd = rbcd.ParallelRound(pp, parallel_pgo.ROUND_CFG, backend=backend,
                             tile_dtype=tile_dtype, device=dev)
    Xb = rbcd.pack_states(pp, states, dev)
    rows = torch.cat([a * pp.n_max + torch.arange(g.n)
                      for a, g in enumerate(graphs)])

    def global_state(Xs):
        return RAState(rot=Xs.rot.reshape(-1, r, d)[rows],
                       sph=Xs.sph.reshape(-1, r),
                       trn=Xs.trn.reshape(-1, r)[rows])

    central = LocalGraph(0, r, d)
    central.set_measurements(ms)
    P = central.problem_data(device=dev)
    G0 = lifted.zeros(central.dims, r, device=dev)

    def evaluate(Xs):
        Xg = global_state(Xs)
        return (2.0 * float(prob.cost(P, Xg)),
                float(riemannian_gradient(P, Xg, G0).norm()))

    Xb, rounds, trace, gradnorm, _ = rbcd.run_rounds(
        rnd, Xb, max_rounds, check_every, 0.1, evaluate)
    return (Xb, rounds, trace, gradnorm,
            2.0 * float(prob.cost(P, global_state(Xb))),
            pp.scalar_columns())


@pytest.mark.parametrize("backend, dtype", [("edge", torch.float64),
                                            ("tiled", torch.float32)])
def test_run_is_the_one_function_drivers(data_dir, backend, dtype):
    path = os.path.join(data_dir, "smallGrid3D.g2o")
    res = parallel_pgo.run(AGENTS, path, r=R, max_rounds=12, check_every=5,
                           backend=backend, tile_dtype=dtype, device="cpu")
    Xb, rounds, trace, gradnorm, cost, columns = _parent_run(
        AGENTS, path, R, 12, 5, backend, dtype)
    for got, want in zip(res.X_stack, Xb):
        assert torch.equal(got, want)
    assert (res.rounds, res.trace, res.gradnorm, res.cost, res.columns) \
        == (rounds, trace, gradnorm, cost, columns)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The 6^3 grid with grid3d's parameters: the reference's problem, its
    fleet and chordal start, and the port's set-up from that start."""
    cfg = json.load(open(os.path.join(ROOT, "port_bench", "configs",
                                      "grid3d_r5.json")))
    path = str(tmp_path_factory.mktemp("r5") / "grid.g2o")
    generators.grid_g2o(path, seed=cfg["structure_seed"],
                        **dict(cfg["params"], shape=[6, 6, 6]))
    g = ref_graph.read(path)
    P = Problem(g)
    mix = json.load(open(os.path.join(ROOT, "port_bench", "traffic",
                                      "rbcd.json")))
    fleet = Fleet(P, AGENTS, Budget(max_outer=1,
                                    max_inner=mix["max_inner"],
                                    gradnorm_tol=mix["gradnorm_tol"]),
                  mix["max_rejections"])
    s = start.chordal(g, R)
    ds = read_g2o_file(path)
    setup = parallel_pgo.prepare(
        AGENTS, ds.pose_pose_measurements, ds.num_poses, ds.dim, R,
        backend="edge", device="cpu",
        start=RAState(*(torch.as_tensor(x) for x in s)))
    return dict(P=P, fleet=fleet, setup=setup)


def _flat(grid, Xs):
    return grid["P"].flat(*grid["setup"].global_state(Xs))


def test_linear_term_is_the_references(grid):
    setup, fleet = grid["setup"], grid["fleet"]
    rnd = setup.rnd
    X1, _ = rnd(setup.Xb)  # neighbours a round away from the start
    G = rnd.linear_term(X1, rnd.fixed_states(rnd.exchange(rnd.publish(X1)),
                                             R))
    Xg = _flat(grid, X1)
    for a, (first, count) in enumerate(fleet.parts):
        want = fleet.linear_term(Xg, a)
        got = torch.cat([G.rot[a, :count].permute(1, 0, 2).reshape(R, -1),
                         G.trn[a, :count].T], 1)
        assert float(torch.linalg.vector_norm(got - want)) <= \
            1e-12 * float(torch.linalg.vector_norm(want)), a


def test_round_lowers_every_block_and_its_gradnorms(grid):
    setup, fleet = grid["setup"], grid["fleet"]
    X0 = setup.Xb
    X1, gnorms = setup.rnd(X0)
    F0, F1 = _flat(grid, X0), _flat(grid, X1)
    f0 = grid["P"].cost(F0)
    for a, blk in enumerate(fleet.blocks):
        assert fleet.block_cost(F0, a, F1[:, blk.cols]) < f0, a
        want = fleet.block_gradnorm(F0, F1, a)
        assert abs(float(gnorms[a]) - want) <= 1e-10 * want, a
    assert fleet.block_rise(F0, F1) == 0.0


def test_round_records_spans_and_counters(grid):
    setup = grid["setup"]
    timing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        _, rounds, trace, _, _ = rbcd.run_rounds(
            setup.rnd, setup.Xb, 3, 2, 0.0, setup.evaluate)
    spans = {}
    for e in p.profiler.kineto_results.events():
        if e.name().startswith("dcora.rbcd."):
            spans.setdefault(e.name()[len("dcora."):], []).append(
                (e.start_ns(), e.end_ns()))
    assert rounds == 3 and len(trace) == 2  # rounds 0 and 2 checked
    assert {k: len(v) for k, v in spans.items()} == {
        "rbcd.round": 3, "rbcd.exchange": 3, "rbcd.update": 3,
        "rbcd.evaluate": 2}
    for part in ("rbcd.exchange", "rbcd.update"):
        assert all(any(s <= a and b <= e for s, e in spans["rbcd.round"])
                   for a, b in spans[part])
    c = timing.counters()
    assert c["rbcd.rounds"] == 3 and c["rbcd.agent_updates"] == 3 * AGENTS
    assert c["tcg.useful"] > 0
    assert np.isfinite(trace[-1][1])
