"""The port's robust layer against the JAX package on the same inputs:
RobustCost for every cost type and its GNC mu schedule, chi2inv, the
single and robust rotation / translation / pose averaging, and
solve_robust_pgo on a corrupted small grid (every stage on the edge path,
below the tiled solver's 500-pose threshold).

Inputs are made with numpy from a seed.  Tolerances: the host functions
(weights, chi2inv, averaging) agree to 1e-12.  solve_robust_pgo rejects and
accepts the same edges, its undecided weights agree to 1e-5 (each is a
function of a residual at an iterate that both engines reach only to the
solver's gradient tolerance, 1e-9 here; 5e-5 with the port's numpy
Jacobi build), and its trajectory, with pose 0 moved to the identity,
agrees to 2e-7 of the largest coordinate (PGO without a prior is defined
up to one rigid motion, along which the two solves drift apart by ~1e-3
at the same cost) with the port's numpy Jacobi build, and to 1e-7 with
its native one, set from the spread of the JAX package against itself
(its threadings and its two builds).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dcora_tpu.core.robust as jrobust
import dcora_tpu.solvers as jsolvers
import dcora_tpu.types as jtypes
import dcora_tpu_torch.core.robust as trobust
import dcora_tpu_torch.solvers as tsolvers
import dcora_tpu_torch.types as ttypes
from dcora_tpu.datasets import _rand_rotation

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
COST_TYPES = ["L2", "L1", "Huber", "TLS", "GM", "GNC_TLS"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's host loops issue small tensor ops, which a multi-threaded
    pool only slows down beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(types, name, **kw):
    return types.RobustCostParameters(costType=types.RobustCostType[name],
                                      **kw)


@pytest.mark.parametrize("name", COST_TYPES)
def test_robust_cost_weights_match(name):
    rng = np.random.default_rng(0)
    r = np.concatenate([rng.uniform(0.01, 20.0, 200), [0.0, 5.0, 10.0, 3.0]])
    if name == "L1":
        r = r[r > 0]
    kw = dict(GNCBarc=4.0, GNCInitMu=0.05, HuberThreshold=2.5,
              TLSThreshold=7.0)
    cj = jrobust.RobustCost(_params(jtypes, name, **kw))
    ct = trobust.RobustCost(_params(ttypes, name, **kw))
    for _ in range(4):  # the weights along the mu schedule
        np.testing.assert_allclose(ct.weight(r), cj.weight(r), rtol=1e-12,
                                   atol=0)
        assert float(ct.weight(r[0])) == float(cj.weight(r[0]))
        cj.update()
        ct.update()
        assert ct.mu == cj.mu


def test_gnc_mu_schedule_and_reset():
    kw = dict(GNCMaxNumIters=5, GNCMuStep=1.7, GNCInitMu=1e-3)
    cj = jrobust.RobustCost(_params(jtypes, "GNC_TLS", **kw))
    ct = trobust.RobustCost(_params(ttypes, "GNC_TLS", **kw))
    mus = []
    for _ in range(9):  # past GNCMaxNumIters mu freezes
        cj.update()
        ct.update()
        assert ct.mu == cj.mu and ct._gnc_iteration == cj._gnc_iteration
        mus.append(ct.mu)
    assert mus[4] == pytest.approx(1e-3 * 1.7 ** 5) and mus[-1] == mus[4]
    ct.reset()
    cj.reset()
    assert ct.mu == cj.mu == 1e-3 and ct._gnc_iteration == 0


@pytest.mark.parametrize("q,dof", [(0.5, 3), (0.9, 6), (0.99, 6),
                                   (0.999, 3), (1e-4, 1)])
def test_chi2inv_matches(q, dof):
    from scipy.stats import chi2

    assert trobust.chi2inv(q, dof) == jrobust.chi2inv(q, dof)
    assert trobust.chi2inv(q, dof) == pytest.approx(chi2.ppf(q, dof),
                                                    rel=1e-10)


@pytest.mark.parametrize("dim,q", [(3, 0.9), (2, 0.95), (3, 1.0)])
def test_error_threshold_at_quantile(dim, q):
    assert (trobust.RobustCost.compute_error_threshold_at_quantile(q, dim)
            == jrobust.RobustCost.compute_error_threshold_at_quantile(q, dim))


def _rotations(rng, n, spread, outliers=0):
    base = _rand_rotation(rng, np.pi)
    Rs = [base @ _rand_rotation(rng, spread) for _ in range(n - outliers)]
    Rs += [_rand_rotation(rng, np.pi) for _ in range(outliers)]
    return Rs


def test_single_averaging_matches():
    rng = np.random.default_rng(1)
    Rs = _rotations(rng, 7, 0.2)
    ts = [rng.standard_normal(3) for _ in range(7)]
    w = rng.uniform(0.5, 2.0, 7)
    np.testing.assert_allclose(tsolvers.single_rotation_averaging(Rs, w),
                               jsolvers.single_rotation_averaging(Rs, w),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tsolvers.single_translation_averaging(ts, w),
                               jsolvers.single_translation_averaging(ts, w),
                               rtol=0, atol=1e-12)
    for a, b in zip(tsolvers.single_pose_averaging(Rs, ts, w, w),
                    jsolvers.single_pose_averaging(Rs, ts, w, w)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    R = tsolvers.single_rotation_averaging(Rs)
    assert np.linalg.det(R) == pytest.approx(1.0)
    np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-12)


@pytest.mark.parametrize("seed", [2, 3])
def test_robust_rotation_averaging_matches(seed):
    """The GNC-TLS loop on 12 rotations of which 3 are gross outliers: the
    same estimate and the same inliers as the JAX package."""
    from dcora_tpu_torch.utils.rotations import angular_to_chordal_so3

    rng = np.random.default_rng(seed)
    Rs = _rotations(rng, 12, 0.05, outliers=3)
    thr = angular_to_chordal_so3(0.5)
    Rt, inl_t = tsolvers.robust_single_rotation_averaging(Rs, None, thr)
    Rj, inl_j = jsolvers.robust_single_rotation_averaging(Rs, None, thr)
    assert inl_t == inl_j and set(inl_t) <= set(range(9))
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-12)


def test_robust_pose_averaging_matches():
    rng = np.random.default_rng(4)
    Rs = _rotations(rng, 10, 0.02, outliers=2)
    t0 = rng.standard_normal(3)
    ts = [t0 + 0.01 * rng.standard_normal(3) for _ in range(8)]
    ts += [10 * rng.standard_normal(3) for _ in range(2)]
    Rt, tt, inl_t = tsolvers.robust_single_pose_averaging(Rs, ts,
                                                          error_threshold=5)
    Rj, tj, inl_j = jsolvers.robust_single_pose_averaging(Rs, ts,
                                                          error_threshold=5)
    assert inl_t == inl_j
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-12)


def test_measurement_error_matches():
    from torch_port_common import build_graphs, random_graph_spec

    rng = np.random.default_rng(5)
    gj, gt = build_graphs(random_graph_spec(rng, l=0, b=0), prior=False)
    R1, R2 = _rand_rotation(rng, 1.0), _rand_rotation(rng, 1.0)
    t1, t2 = rng.standard_normal(3), rng.standard_normal(3)
    for mj, mt in zip(gj.all_measurements(), gt.all_measurements()):
        assert tsolvers.compute_measurement_error(mt, R1, t1, R2, t2) == \
            pytest.approx(jsolvers.compute_measurement_error(
                mj, R1, t1, R2, t2), rel=1e-14)


def _corrupted(data_dir, meas, datasets):
    from dcora_tpu.io import read_g2o_file as jread

    clean = jread(os.path.join(data_dir, "smallGrid3D.g2o"))
    out, keys = datasets.corrupt_with_outliers(
        clean.pose_pose_measurements, frac=0.15, seed=7)
    # the same list, as the port's measurement objects
    if meas is not None:
        out = [meas.RelativePosePoseMeasurement(
            m.r1, m.p1, m.r2, m.p2, m.R, m.t, m.kappa, m.tau,
            weight=m.weight, fixedWeight=m.fixedWeight) for m in out]
    return out, keys


def _robust_gnc_gaps(data_dir, monkeypatch, port_native):
    """GNC on smallGrid3D (125 poses) with 15 % planted gross outliers, at
    a few stages, in both engines (the JAX package on its default host
    path; the port on its native or its numpy one).  Checks the rejected
    and accepted sets and the stage log; returns the largest weight gap
    and the trajectory gap relative to the largest coordinate."""
    import dcora_tpu_torch.native as tnative
    import dcora_tpu.datasets as jds
    import dcora_tpu_torch.measurements as tmeas
    from dcora_tpu_torch.core.lifted import pose_inverse, pose_multiply

    ms_j, keys = _corrupted(data_dir, None, jds)
    ms_t, _ = _corrupted(data_dir, tmeas, jds)
    kw = dict(GNCMaxNumIters=6)
    pj = jsolvers.SolveRobustPGOParams(
        opt_params=jtypes.ROptParameters(gradnorm_tol=1e-9,
                                         RTR_iterations=50),
        robust_params=_params(jtypes, "GNC_TLS", **kw))
    pt = tsolvers.SolveRobustPGOParams(
        opt_params=ttypes.ROptParameters(gradnorm_tol=1e-9,
                                         RTR_iterations=50),
        robust_params=_params(ttypes, "GNC_TLS", **kw))
    stats = []
    Tj = jsolvers.solve_robust_pgo(ms_j, pj)
    if port_native:
        assert tsolvers.precond_build() == "native"
    else:
        monkeypatch.setattr(tnative, "get_library", lambda: None)
    Tt = tsolvers.solve_robust_pgo(ms_t, pt, device="cpu", stats=stats)
    wj = np.array([m.weight for m in ms_j])
    wt = np.array([m.weight for m in ms_t])
    np.testing.assert_array_equal(wt < 1e-8, wj < 1e-8)
    np.testing.assert_array_equal(wt > 1 - 1e-8, wj > 1 - 1e-8)
    assert len(stats) >= 3 and all("init_s" in s for s in stats)
    rejected = {(m.p1, m.p2) for m in ms_t if m.weight < 1e-8}
    assert rejected and rejected <= keys

    def gauge(T):
        inv = pose_inverse(T[0])
        return np.stack([pose_multiply(inv, Ti) for Ti in T])

    scale = float(np.abs(Tj).max())
    return (float(np.abs(wt - wj).max()),
            float(np.abs(gauge(Tt) - gauge(Tj)).max()) / scale)


def test_solve_robust_pgo_matches_jax(data_dir, monkeypatch):
    """Every final weight and the trajectory agree, the port building its
    block-Jacobi preconditioner in numpy.  The gates come from the spread
    of each engine against itself at this seed (7), measured with
    tests/gnc_host_path_spread.py traces --robust under XLA's default
    threading and single-threaded Eigen, then spread (CPU runs, 8-core
    x86 host): the JAX package moves against itself, over its two
    threadings and its native and numpy host paths, by up to 1.39e-5 in a
    weight and 6.12e-8 in the trajectory; the port over its two host
    paths by 1.37e-5 and 2.88e-8 (not at all with XLA's threading).  The
    port's numpy path lies 1.22e-5 / 2.87e-8 from JAX's default host path
    under the default threading and 6.32e-6 / 2.15e-8 under one thread, so
    the old gates, 1e-5 and 1e-8, sat below JAX's own spread.  The gates,
    5e-5 and 2e-7, are about three times it.  Seeds 8 and 9: JAX against
    itself up to 3.75e-7 / 1.36e-8 and 1.78e-5 / 2.28e-7."""
    w_gap, traj_gap = _robust_gnc_gaps(data_dir, monkeypatch, False)
    assert w_gap <= 5e-5
    assert traj_gap <= 2e-7


def test_solve_robust_pgo_native_matches_jax(data_dir, monkeypatch):
    """The same on the port's default host path, the native Jacobi build
    (bit for bit the JAX package's on the same problem data,
    test_torch_native.py).  The gates come from the spread of the JAX
    package against itself (tests/gnc_host_path_spread.py, PERF.md §6):
    its native and numpy builds differ only in the
    preconditioner's last ulps, yet over corruption seeds 7-11 their GNC
    solves land up to 1.8e-5 apart in a weight and 1.6e-7 in the
    trajectory (seed 9; 7.3e-7 and 3.1e-9 at seed 7).  Port native
    against JAX native lands at most 5.3e-6 and 5.0e-8 apart over the
    same seeds.  The gates, 1e-5 and 1e-7, lie between the two."""
    w_gap, traj_gap = _robust_gnc_gaps(data_dir, monkeypatch, True)
    assert w_gap <= 1e-5
    assert traj_gap <= 1e-7


def test_solve_robust_pgo_params_default():
    a, b = tsolvers.SolveRobustPGOParams(), jsolvers.SolveRobustPGOParams()
    for f in ("gradnorm_tol", "RTR_iterations", "RTR_tCG_iterations",
              "RTR_initial_radius"):
        assert getattr(a.opt_params, f) == getattr(b.opt_params, f)
    for f in ("GNCMaxNumIters", "GNCBarc", "GNCMuStep", "GNCInitMu"):
        assert getattr(a.robust_params, f) == getattr(b.robust_params, f)
    assert a.verbose is b.verbose is False


def test_new_modules_import_without_jax():
    """The robust and multi-robot modules import without JAX (fresh
    interpreter)."""
    mods = ["dcora_tpu_torch.core.robust", "dcora_tpu_torch.core.device",
            "dcora_tpu_torch.agent",
            "dcora_tpu_torch.solvers", "dcora_tpu_torch.utils.checkpoint",
            "dcora_tpu_torch.drivers.single_robot_gnc",
            "dcora_tpu_torch.drivers.chordal_initialization_example",
            "dcora_tpu_torch.drivers.multi_robot_pgo",
            "dcora_tpu_torch.drivers.multi_robot_raslam",
            "dcora_tpu_torch.tools.robust_bench"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'dcora_tpu.')) or "
            "m == 'dcora_tpu']\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
