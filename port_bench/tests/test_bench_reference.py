"""The plain reference against the port's plain path on problems a CPU
solves in seconds: cost, X Q, the starts, the trust-region solve and the
certificate."""

import numpy as np
import pytest
import torch

from dcora_tpu_torch.core import lifted, problem as prob, rtr
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import chordal_initialization
from dcora_tpu_torch.io import read_g2o_file, read_pyfg_file
from dcora_tpu_torch.io.remap import get_global_measurements
from dcora_tpu_torch.solvers import make_preconditioner
from dcora_tpu_torch.types import GraphType
from port_bench.reference import generators, graph, start
from port_bench.reference.problem import Problem, certificate_psd
from port_bench.reference.rtr import Budget, Solver


def _grid(tmp_path):
    return generators.grid_g2o(str(tmp_path / "g.g2o"), shape=(4, 3, 3),
                               loop_prob=0.9, seed=7)


def _ra(tmp_path):
    return generators.ra_slam_pyfg(
        str(tmp_path / "r.pyfg"), num_robots=3, poses_per_robot=12,
        num_landmarks=2, range_prob=1.0, rot_noise=0.01, trans_noise=0.01,
        range_noise=0.01, seed=5)


def _port(path, r):
    if path.endswith(".g2o"):
        g = LocalGraph(0, r, 3)
        g.set_measurements(read_g2o_file(path).pose_pose_measurements)
    else:
        g = LocalGraph(0, r, 3, GraphType.RangeAidedSLAMGraph)
        g.set_measurements(get_global_measurements(
            read_pyfg_file(path)).relative_measurements)
    return g, g.problem_data(device="cpu")


@pytest.mark.parametrize("make", [_grid, _ra])
def test_cost_and_gradient_are_the_ports(tmp_path, make):
    path = make(tmp_path)
    G = graph.read(path)
    g, P = _port(path, 5)
    assert (g.n, g.l, g.b) == (G.n, G.l, G.b)
    gen = torch.Generator().manual_seed(0)
    X = lifted.RAState(*(torch.randn(s, generator=gen, dtype=torch.float64)
                         for s in ((G.n, 5, 3), (G.l, 5), (G.n + G.b, 5))))
    RP = Problem(G)
    Xf = RP.flat(*X)
    f = float(prob.cost(P, X))
    assert abs(RP.cost(Xf) - f) <= 1e-12 * f
    W = lifted.to_flat(prob.apply_Q(P, X))
    assert float((RP.QX(Xf) - W).abs().max()) <= 1e-12 * float(W.abs().max())


def test_chordal_start_matches_the_ports(tmp_path):
    path = _grid(tmp_path)
    G = graph.read(path)
    rot, sph, trn = start.chordal(G, 3)
    T = chordal_initialization(read_g2o_file(path).pose_pose_measurements,
                               device="cpu")
    RP = Problem(G)
    f_ref = RP.cost(RP.flat(*(torch.as_tensor(a) for a in (rot, sph, trn))))
    Xp = lifted.from_pose_array(T)
    f_port = RP.cost(RP.flat(*Xp))
    assert abs(f_ref - f_port) <= 1e-6 * f_port


def test_odometry_start_composes_the_chain(tmp_path):
    path = _ra(tmp_path)
    G = graph.read(path)
    rot, sph, trn = start.odometry(G, 3, seed=11)
    first = G.robots[1][0]
    assert np.allclose(rot[first], G.gt_T[first][:, :3])
    assert np.allclose(np.linalg.norm(sph, axis=1), 1.0)
    assert np.all(np.abs(trn[G.n:]) <= 1.0)


@pytest.mark.parametrize("make", [_grid, _ra])
def test_trust_region_reaches_the_ports_cost(tmp_path, make):
    path = make(tmp_path)
    G = graph.read(path)
    r = 5 if G.is_pgo else 3
    s = start.chordal(G, r) if G.is_pgo else start.odometry(G, r, seed=1)
    g, P = _port(path, r)
    M = make_preconditioner(g, P)
    X0 = lifted.RAState(*(torch.as_tensor(a) for a in s))
    cfg = rtr.RTRConfig(gradnorm_tol=1e-30, max_outer=30, max_inner=200)
    f_port = float(rtr.rtr(P, None, M, X0, cfg).f_final)
    RP = Problem(G)
    _, f_ref, _, _ = Solver(RP, Budget(max_outer=30, max_inner=200)).solve(
        RP.flat(*X0))
    assert abs(f_ref - f_port) <= 1e-6 * f_port


def test_certificate_of_the_ports_certified_optimum(tmp_path):
    from dcora_tpu_torch.drivers import single_robot_pgo

    path = _grid(tmp_path)
    res = {}
    single_robot_pgo.run(path, certify=True, device="cpu", verbose=False,
                         result=res)
    st = res["staircase"]
    assert st.certified
    G = graph.read(path)
    RP = Problem(G)
    X = RP.flat(*st.X).numpy()
    assert certificate_psd(G, X, 1e-3) is True
    gen = np.random.default_rng(0)
    assert certificate_psd(G, gen.standard_normal(X.shape), 1e-3) is not True
