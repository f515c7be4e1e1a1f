"""The port's agent (dcora_tpu_torch.agent) against the JAX package's on the
same restricted problem: one agent of a 3-robot partition of smallGrid3D,
its neighbors' public states made with numpy from a seed.

  * update_X: the one-accepted-step RTR (RTRConfig.single_accepted_step)
    and the RGD step, with and without acceleration;
  * the one-accepted-step RTR itself, when its first tries are rejected;
  * the Nesterov Y / V updates as plain tensor functions;
  * the GNC weight update, the reclassification, the max residual and the
    undecided count, and the shared public states.

Tolerance: 1e-10 of the state's largest entry (both engines run the same
f64 operations on the same inputs; the rounding of the sums differs).
"""

import numpy as np
import pytest
import torch

import dcora_tpu.agent as jagent
import dcora_tpu.types as jtypes
import dcora_tpu_torch.agent as tagent
import dcora_tpu_torch.measurements as tmeas
import dcora_tpu_torch.types as ttypes
from dcora_tpu.core import lifted as jlifted
from dcora_tpu.core import manifold as jmanifold
from torch_port_common import (assert_state_close, jax_state, np_of,
                               torch_state)

R, D, ROBOTS = 5, 3, 3
BARC = 300.0  # puts part of the residuals inside the GNC band at mu 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def partition(data_dir):
    import os

    from dcora_tpu.drivers.multi_robot_pgo import partition_measurements
    from dcora_tpu.io import read_g2o_file

    ds = read_g2o_file(os.path.join(data_dir, "smallGrid3D.g2o"))
    odo, priv, shared, _ = partition_measurements(
        ds.pose_pose_measurements, ds.num_poses, ROBOTS)
    return ds, odo, priv, shared


def _port_copy(ms):
    """The same measurements as the port's objects, shared edges kept
    shared (one object per JAX object)."""
    memo = {}
    out = []
    for m in ms:
        if id(m) not in memo:
            memo[id(m)] = tmeas.RelativePosePoseMeasurement(
                m.r1, m.p1, m.r2, m.p2, m.R, m.t, m.kappa, m.tau,
                weight=m.weight, fixedWeight=m.fixedWeight)
        out.append(memo[id(m)])
    return out


def _global_state(rng, n):
    """A lifted state of all poses near the identity chain (numpy)."""
    A = np.tile(np.eye(R, D), (n, 1, 1)) + 0.1 * rng.standard_normal(
        (n, R, D))
    U, _, Vt = np.linalg.svd(A, full_matrices=False)
    trn = np.cumsum(np.ones((n, R)) * 0.2, axis=0) + \
        0.3 * rng.standard_normal((n, R))
    return U @ Vt, trn


def _agents(partition, robot=1, acceleration=False, robust=False,
            method="RTR", seed=0):
    """(JAX agent, port agent), initialized at the same iterate, with the
    same neighbor states cached."""
    ds, odo, priv, shared = partition
    n = ds.num_poses
    rng = np.random.default_rng(seed)
    rot, trn = _global_state(rng, n)
    npr = n // ROBOTS
    s, e = robot * npr, (n if robot == ROBOTS - 1 else (robot + 1) * npr)
    ms_j = odo[robot] + priv[robot] + shared[robot]
    ms_t = _port_copy(ms_j)
    out = []
    for mod, T, ms in ((jagent, jtypes, ms_j), (tagent, ttypes, ms_t)):
        p = T.AgentParameters(d=D, r=R, robotIDs=frozenset(range(ROBOTS)),
                              acceleration=acceleration)
        if robust:
            p.robustCostParams = T.RobustCostParameters(
                costType=T.RobustCostType.GNC_TLS, GNCBarc=BARC,
                GNCInitMu=0.5)
        p.localOptimizationParams.method = T.ROptMethod[method]
        kw = {} if mod is jagent else dict(
            device="cpu",
            lifting_matrix=np.asarray(jmanifold.fixed_lifting_matrix(R, D)))
        a = mod.Agent(robot, p, **kw)
        if robot != 0:
            a.set_lifting_matrix(np.asarray(
                jmanifold.fixed_lifting_matrix(R, D)))
        a.set_measurements(ms)
        a.initialize()
        arrs = (rot[s:e], np.zeros((0, R)), trn[s:e])
        a.set_X(jax_state(arrs) if mod is jagent else torch_state(arrs))
        for nb in range(ROBOTS):
            if nb == robot:
                continue
            status = T.AgentStatus(nb, T.AgentState.INITIALIZED, 0, 0,
                                   False, 0.0)
            a.set_neighbor_status(status)
            ns = nb * npr
            ne = n if nb == ROBOTS - 1 else (nb + 1) * npr
            pd = {T.PoseID(nb, i): np.concatenate(
                [rot[ns + i], trn[ns + i][:, None]], axis=1)
                for i in range(ne - ns)}
            a.update_neighbor_states(nb, pd)
            if acceleration:
                a.update_neighbor_states(nb, pd, aux=True)
        out.append(a)
    return out


@pytest.mark.parametrize("robot", [0, 2])
def test_agent_preconditioner_is_the_jax_agents(partition, robot):
    """An agent's block-Jacobi preconditioner comes from the same host
    build as the JAX agent's (solvers.make_preconditioner: the native
    assembly when its library is built), bit for bit on AVX-512 hosts and
    to a few ulps elsewhere (test_torch_native.py)."""
    from dcora_tpu_torch import native as tnative
    from dcora_tpu_torch import solvers as tsolvers

    aj, at = _agents(partition, robot=robot)
    assert aj.update_X(True, acceleration=False)
    assert at.update_X(True, acceleration=False)
    assert tsolvers.precond_build() == "native"
    # the numpy build differs from the native one by ~1e-15 of max, so
    # only the bitwise check tells the builds apart
    bitwise = "-march=x86-64-v4" in tnative.cxx_flags()
    for a, b in zip(at._cached_M, aj._cached_M):
        b = np_of(b)
        if bitwise:
            np.testing.assert_array_equal(np_of(a), b)
        else:
            np.testing.assert_allclose(
                np_of(a), b, rtol=0, atol=1e-14 * np.abs(b).max(initial=1.0))


@pytest.mark.parametrize("robot", [0, 1, 2])
def test_update_x_single_accepted_step_matches(partition, robot):
    aj, at = _agents(partition, robot=robot)
    for _ in range(3):
        assert aj.update_X(True, acceleration=False)
        assert at.update_X(True, acceleration=False)
        assert_state_close(at.get_X(), aj.get_X())
        assert int(at.local_opt_result.outer_iters) == \
            int(aj.local_opt_result.outer_iters)
        assert bool(at.local_opt_result.accepted) == \
            bool(aj.local_opt_result.accepted)


def test_iterate_with_acceleration_matches(partition):
    aj, at = _agents(partition, acceleration=True)
    for _ in range(4):
        aj.iterate(True)
        at.iterate(True)
        assert_state_close(at.get_X(), aj.get_X())
        assert_state_close(at.Y, aj.Y)
        assert_state_close(at.V, aj.V)
        assert at.gamma == pytest.approx(aj.gamma, rel=1e-15)
        assert at.status.relativeChange == pytest.approx(
            aj.status.relativeChange, rel=1e-10)
        assert at.status.readyToTerminate == aj.status.readyToTerminate


def test_rgd_step_matches(partition):
    aj, at = _agents(partition, method="RGD")
    for _ in range(2):
        aj.update_X(True, acceleration=False)
        at.update_X(True, acceleration=False)
        assert_state_close(at.get_X(), aj.get_X())


def test_rgd_step_function_matches():
    """rtr.rgd_step with and without the preconditioner on a random pose
    graph with random weights.  No prior: the JAX package's native
    preconditioner build leaves out the prior's diagonal, which its numpy
    build (the port's) adds."""
    import dcora_tpu.core.rtr as jrtr
    import dcora_tpu.solvers as jsolvers
    import dcora_tpu_torch.core.rtr as trtr
    import dcora_tpu_torch.solvers as tsolvers
    from dcora_tpu_torch import convert
    from torch_port_common import (build_graphs, random_graph_spec,
                                   random_state_arrays)

    rng = np.random.default_rng(3)
    gj, gt = build_graphs(random_graph_spec(rng, l=0, b=0), r=5,
                            prior=False)
    Pj, Pt = gj.problem_data(), gt.problem_data()
    Mj = jsolvers.make_preconditioner(gj, Pj)
    Mt = tsolvers.make_preconditioner(gt, Pt)
    arrs = random_state_arrays(rng, gj.dims, 5)
    G = random_state_arrays(rng, gj.dims, 5)
    for use_m in (True, False):
        Xj = jrtr.rgd_step(Pj, jax_state(G), Mj if use_m else None,
                           jax_state(arrs), 1e-3)
        Xt = trtr.rgd_step(Pt, torch_state(G), Mt if use_m else None,
                           torch_state(arrs), 1e-3)
        assert_state_close(Xt, Xj)
        Xc = trtr.rgd_step(convert.problem_data(Pj), torch_state(G),
                           convert.preconditioner(Mj) if use_m else None,
                           torch_state(arrs), 1e-3)
        assert_state_close(Xc, Xj)


@pytest.mark.parametrize("radius", [100.0, 1e4])
def test_single_accepted_step_rejections_match(radius):
    """From a far-off point with a large radius the first tries are
    rejected; the radius shrinks by 4 per try in both engines."""
    import dataclasses

    import dcora_tpu.core.rtr as jrtr
    import dcora_tpu.solvers as jsolvers
    import dcora_tpu_torch.core.rtr as trtr
    import dcora_tpu_torch.solvers as tsolvers
    from torch_port_common import (build_graphs, random_graph_spec,
                                   random_state_arrays)

    rng = np.random.default_rng(7)
    gj, gt = build_graphs(random_graph_spec(rng, n=12, l=0, b=0), r=5,
                            prior=False)
    Pj, Pt = gj.problem_data(), gt.problem_data()
    Mj = jsolvers.make_preconditioner(gj, Pj)
    Mt = tsolvers.make_preconditioner(gt, Pt)
    arrs = random_state_arrays(rng, gj.dims, 5)
    arrs = (arrs[0], arrs[1], 30.0 * arrs[2])
    G = tuple(np.zeros_like(a) for a in arrs)
    kw = dict(gradnorm_tol=1e-6, max_inner=50, initial_radius=radius,
              single_accepted_step=True)
    rj = jrtr.rtr(Pj, jax_state(G), Mj, jax_state(arrs),
                  jrtr.RTRConfig(**kw))
    rt = trtr.rtr(Pt, torch_state(G), Mt, torch_state(arrs),
                  trtr.RTRConfig(**kw))
    assert rt.outer_iters == int(rj.outer_iters) >= 1
    assert rt.accepted == bool(rj.accepted)
    assert float(rt.radius_final) == pytest.approx(
        float(rj.radius_final), rel=1e-15)
    assert_state_close(rt.X, rj.X)
    assert float(rt.f_final) == pytest.approx(float(rj.f_final), rel=1e-10)
    # already below tolerance: no try at all
    cfg = dataclasses.replace(trtr.RTRConfig(**kw), gradnorm_tol=1e30)
    res = trtr.rtr(Pt, torch_state(G), Mt, torch_state(arrs), cfg)
    assert res.outer_iters == 0 and res.accepted


def test_nesterov_updates_match():
    from dcora_tpu.types import ProblemDims
    from torch_port_common import random_state_arrays

    rng = np.random.default_rng(11)
    dims = ProblemDims(3, 9, 4, 2)
    X, V, Y = (random_state_arrays(rng, dims, 5) for _ in range(3))
    for alpha, gamma in ((0.3, 1.7), (1.0, 0.0)):
        Yj = jagent._update_Y_jit(jax_state(X), jax_state(V), alpha)
        Yt = tagent.update_Y(torch_state(X), torch_state(V), alpha)
        assert_state_close(Yt, Yj)
        Vj = jagent._update_V_jit(jax_state(V), jax_state(X), jax_state(Y),
                                  gamma)
        Vt = tagent.update_V(torch_state(V), torch_state(X), torch_state(Y),
                             gamma)
        assert_state_close(Vt, Vj)
    Xt = torch_state(X)
    Yt = torch_state(Y)
    d = tagent.max_translation_distance(Xt, Yt)
    assert d == pytest.approx(jagent.max_translation_distance(
        jax_state(X), jax_state(Y)), rel=1e-14)


def test_gnc_weight_update_and_reclassify_match(partition):
    aj, at = _agents(partition, robust=True)

    def weights(a):
        return np.array([m.weight for m in a.graph.all_measurements()])

    assert at.max_measurement_residual() == pytest.approx(
        aj.max_measurement_residual(), rel=1e-12)
    aj.update_measurement_weights()
    at.update_measurement_weights()
    np.testing.assert_allclose(weights(at), weights(aj), rtol=0, atol=1e-12)
    assert at.robust_cost.mu == aj.robust_cost.mu
    assert at.weight_update_count == aj.weight_update_count == 1
    assert at.num_undecided_measurements() == \
        aj.num_undecided_measurements() > 0
    # a few solves on the re-weighted problem, then re-judge every weight
    for _ in range(3):
        aj.update_X(True, acceleration=False)
        at.update_X(True, acceleration=False)
    assert_state_close(at.get_X(), aj.get_X())
    for mu, reset in ((None, False), (0.2, True)):
        if mu is not None:
            aj.set_gnc_mu(mu, reset_schedule=reset)
            at.set_gnc_mu(mu, reset_schedule=reset)
        cj = aj.reclassify_measurement_weights()
        ct = at.reclassify_measurement_weights()
        assert ct == cj
        np.testing.assert_allclose(weights(at), weights(aj), rtol=0,
                                   atol=1e-12)
    assert at.robust_cost._gnc_iteration == aj.robust_cost._gnc_iteration


def test_shared_states_and_trajectory_match(partition):
    aj, at = _agents(partition, robot=1)
    at.update_X(True, acceleration=False)
    aj.update_X(True, acceleration=False)
    dj, dt = aj.get_shared_state_dicts(), at.get_shared_state_dicts()
    for a, b in zip(dt, dj):
        assert {(k.robot_id, k.frame_id) for k in a} == \
            {(k.robot_id, k.frame_id) for k in b}
        for k in b:
            match = [v for kk, v in a.items()
                     if (kk.robot_id, kk.frame_id) == (k.robot_id,
                                                       k.frame_id)]
            np.testing.assert_allclose(match[0], b[k], rtol=0, atol=1e-12)
    anchor = np.asarray(jlifted.RAState.pose(aj.get_X(), 0))
    for a in (aj, at):
        a.set_global_anchor(anchor)
    np.testing.assert_allclose(at.get_trajectory_in_global_frame(),
                               aj.get_trajectory_in_global_frame(),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(at.get_trajectory_in_local_frame(),
                               aj.get_trajectory_in_local_frame(),
                               rtol=0, atol=1e-10)
    for x, y in zip(at.get_states_in_global_frame(),
                    aj.get_states_in_global_frame()):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-10)
    assert np_of(at.get_X().rot).shape == np_of(aj.get_X().rot).shape


def test_agent_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    p = ttypes.AgentParameters(d=D, r=R)
    with pytest.raises(RuntimeError, match="CUDA"):
        tagent.Agent(0, p)


def test_async_loop_runs_and_stops(partition):
    """The asynchronous loop iterates on its own thread at exponential
    intervals from a seeded torch.Generator, and stops on request."""
    import time

    _, at = _agents(partition)
    at.params.asynchronousOptimizationRate = 200.0
    at.start_optimization_loop(torch.Generator().manual_seed(0))
    assert at.is_optimization_running()
    time.sleep(0.3)
    at.end_optimization_loop()
    assert not at.is_optimization_running()
    assert at.iteration_number > 0


def test_termination_and_robot_activity_match(partition):
    """should_terminate over the team statuses, and a neighbor switched
    off: the activity mask reaches the graph, and its states are no longer
    required."""
    aj, at = _agents(partition, robot=1)
    for a in (aj, at):
        a.iterate(True)
    assert at.should_terminate() == aj.should_terminate()
    for a, T in ((aj, jtypes), (at, ttypes)):
        for nb in (0, 2):
            a.set_neighbor_status(T.AgentStatus(
                nb, T.AgentState.INITIALIZED, 0, 1, True, 0.0))
    assert at.should_terminate() == aj.should_terminate()
    for a in (aj, at):
        a.set_robot_active(2, False)
        a.clear_neighbor_states()
    assert at.num_active_robots() == aj.num_active_robots() == 2
    assert at.graph.is_neighbor_active(2) is aj.graph.is_neighbor_active(2)
    assert at.should_terminate() == aj.should_terminate()
    for a in (aj, at):
        assert not a.update_X(True, acceleration=False)  # robot 0 missing
