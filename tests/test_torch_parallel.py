"""The port's synchronous-parallel RBCD (dcora_tpu_torch.parallel.rbcd) on
the edge path against the JAX package's (dcora_tpu.parallel.rbcd) on the
CPU, the JAX side on a one-device mesh (which the JAX package's dry run
shows gives the same blocks as an n-device mesh):

  * the batched problem's arrays (every edge field of P and P_loc, the
    block-Jacobi M, the separator gather maps, the public-buffer indices
    and the regularization per agent): index arrays exactly,
    values to 1e-14 relative (the two engines' file readers round the
    rotations apart by up to 3e-16); JAX's problem carried across by
    dcora_tpu_torch.convert.parallel_problem keeps its arrays exactly;
  * one round to 1e-12 relative, and the drivers' central cost over 10
    rounds (check_every 1) to 1e-10 relative of the JAX rounds' own;
  * the batched round against each agent alone through the single-agent
    core.rtr.rtr (the plain version);
  * a critical point does not move;
  * a set with landmarks raises the same KeyError in both engines.

PGO: the generated smallGrid3D set with 4 agents at rank 5 from the Chordal
init.  RA: a generated 48-pose PyFG set without landmarks (4 robots that
range to each other; the parallel RA mode of both engines cannot run a set
with landmarks) at rank 3 from the odometry init.
"""

import numpy as np
import pytest
import torch
from torch_port_common import (
    PAR_AGENTS as AGENTS,
    PAR_RA_KW as RA_KW,
    JaxParallelRun,
    parallel_paths,
    parallel_ra_graphs,
    rel_err as _rel,
    torch_parallel_problem,
)

ROUND_RTOL = 1e-12
COST_RTOL = 1e-10
VALUE_RTOL = 1e-14


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(data_dir, tmp_path_factory):
    return parallel_paths(data_dir, str(tmp_path_factory.mktemp("par")))


@pytest.fixture(scope="module")
def jax_runs(paths):
    return {k: JaxParallelRun(k, p, 10) for k, p in paths.items()}


def _cfg():
    from dcora_tpu_torch.drivers.parallel_pgo import ROUND_CFG

    return ROUND_CFG


@pytest.mark.parametrize("kind", ["pgo", "ra"])
def test_batched_problem_matches_jax(kind, paths, jax_runs):
    from dcora_tpu_torch import convert

    want = convert.parallel_arrays(jax_runs[kind].pp)
    mine = torch_parallel_problem(kind, paths[kind])
    got = convert.parallel_arrays(mine)
    carried = convert.parallel_arrays(convert.parallel_problem(
        jax_runs[kind].pp, mine.graphs))
    assert all(np.array_equal(carried[k], w) for k, w in want.items())
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if w.dtype.kind in "iu":
            assert np.array_equal(g, w), key
        else:
            assert _rel(g, w) <= VALUE_RTOL, key
    if kind == "ra":
        # lambda_max / (1e6 - 1) of each agent's local Q, not PGO's 1e-1
        assert np.all(want["regs"] != 0.1)
        assert want["fix_sph_src"].size > 0


@pytest.mark.parametrize("kind", ["pgo", "ra"])
def test_edge_round_matches_jax(kind, paths, jax_runs):
    from dcora_tpu_torch import convert
    from dcora_tpu_torch.drivers import parallel_pgo, parallel_raslam
    from dcora_tpu_torch.parallel.rbcd import ParallelRound

    jr = jax_runs[kind]
    rnd = ParallelRound(torch_parallel_problem(kind, paths[kind]), _cfg())
    X1, _ = rnd(convert.ra_state(jr.X0))
    for got, want in zip(X1, jr.states[0]):
        assert _rel(got.numpy(), want) <= ROUND_RTOL
    if kind == "pgo":
        res = parallel_pgo.run(AGENTS, paths[kind], max_rounds=10,
                               rgrad_norm_tol=0.0, check_every=1,
                               backend="edge", device="cpu")
    else:
        res = parallel_raslam.run(paths[kind], max_rounds=10,
                                  rgrad_norm_tol=0.0, check_every=1,
                                  backend="edge", device="cpu")
    costs = [c for _, c, _ in res.trace]
    assert res.rounds == 10 and len(costs) == 10
    assert _rel(costs, jr.costs) <= COST_RTOL
    assert res.cost == pytest.approx(jr.costs[-1], rel=COST_RTOL)
    assert jr.costs[-1] < jr.costs[0]


@pytest.mark.parametrize("kind", ["pgo", "ra"])
def test_batched_round_matches_per_agent_rtr(kind, paths, jax_runs):
    """The stacked RTR gives each agent what the single-agent rtr gives it
    alone (tries, tCG stopping and radius per agent)."""
    from dcora_tpu_torch import convert
    from dcora_tpu_torch.parallel.rbcd import ParallelRound, round_per_agent

    pp = torch_parallel_problem(kind, paths[kind])
    X = convert.ra_state(jax_runs[kind].states[2])
    Xb, gb = ParallelRound(pp, _cfg())(X)
    Xp, gp = round_per_agent(pp, _cfg(), X)
    for a, b in zip(Xb, Xp):
        assert _rel(a.numpy(), b.numpy()) <= ROUND_RTOL
    assert _rel(gb.numpy(), gp.numpy()) <= ROUND_RTOL


def test_critical_point_does_not_move(paths):
    """At a critical point of the central problem every block gradient is
    ~0, so the one-accepted-step update skips and the round returns its
    input (tests/test_parallel.py:test_parallel_matches_sequential_
    fixed_point)."""
    from dcora_tpu_torch.core import lifted
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.core.init import chordal_initialization
    from dcora_tpu_torch.core.lifted import RAState
    from dcora_tpu_torch.core.rtr import RTRConfig, riemannian_gradient, rtr
    from dcora_tpu_torch.drivers.multi_robot_pgo import robot_slice
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.parallel.rbcd import (
        ParallelRound,
        pack_states,
        unpack_states,
    )
    from dcora_tpu_torch.solvers import make_preconditioner

    ds = read_g2o_file(paths["pgo"])
    ms, n, r = ds.pose_pose_measurements, ds.num_poses, 5
    central = LocalGraph(0, r, 3)
    central.set_measurements(ms)
    P = central.problem_data()
    G0 = lifted.zeros(central.dims, r)
    X0 = lifted.pad_rank(lifted.from_pose_array(
        chordal_initialization(ms, device="cpu")), r)
    Xopt = rtr(P, G0, make_preconditioner(central, P), X0,
               RTRConfig(gradnorm_tol=1e-8, max_outer=100,
                         max_inner=200)).X
    assert float(riemannian_gradient(P, Xopt, G0).norm()) < 1e-6
    pp = torch_parallel_problem("pgo", paths["pgo"])
    Xb = pack_states(pp, [
        RAState(rot=Xopt.rot[s:e], sph=Xopt.sph[:0], trn=Xopt.trn[s:e])
        for s, e in (robot_slice(n, AGENTS, a) for a in range(AGENTS))])
    Xb2, gnorms = ParallelRound(pp, _cfg())(Xb)
    parts = unpack_states(pp, Xb2)
    moved = RAState(rot=torch.cat([p.rot for p in parts]),
                    sph=Xopt.sph, trn=torch.cat([p.trn for p in parts]))
    assert float((moved - Xopt).norm()) < 1e-6
    assert float(gnorms.max()) < _cfg().gradnorm_tol


def test_landmarks_raise_the_jax_keyerror(tmp_path):
    """The map agent owns the landmarks and is not one of the agents, so
    no agent publishes them: both engines' builds raise KeyError on the
    first agent that ranges to one (the JAX package's defect, kept)."""
    from dcora_tpu.parallel.rbcd import build_parallel_problem as jbuild
    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.parallel.rbcd import build_parallel_problem

    path = datasets.generate_ra_slam_pyfg(
        str(tmp_path / "ra_lm.pyfg"), **dict(RA_KW, num_landmarks=2,
                                             range_prob=1.0))
    with pytest.raises(KeyError) as ej:
        jbuild(parallel_ra_graphs("jax", path))
    with pytest.raises(KeyError) as et:
        build_parallel_problem(parallel_ra_graphs("torch", path))
    assert repr(et.value.args[0]) == repr(ej.value.args[0])
    assert "Landmark" in repr(et.value.args[0])
