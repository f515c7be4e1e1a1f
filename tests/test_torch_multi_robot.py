"""The port's multi-robot drivers against the JAX package's on the same
generated files, on the CPU:

  * DC2-PGO (multi_robot_pgo.run) on tinyGrid3D with 2 robots from the
    Chordal and the Odometry init: the same certified flag, rank and round
    count, f* and every round's cost to 1e-8 relative;
  * its distributed GNC pipeline on smallGrid3D with 10 % planted
    outliers and 3 robots: every round's cost until the first weight
    update to 1e-7 on the port's numpy host path and 5e-8 on its native
    one (gates from each engine's spread against itself, the tests'
    docstrings); then the same rounds, rank and classification (weight
    < 0.5), the weights to 1e-4 and the final cost to 1e-3 relative.  The
    first update's adaptive mu comes from the team's largest residual,
    which the two engines' iterates give to ~1e-10 relative after 50
    rounds; later rounds amplify that difference (10 rounds later the
    costs differ by 3e-6 relative, at the end by 3.3e-5; the weights by
    1.7e-6);
  * DCORA (multi_robot_raslam.run) on the small RA set at a cut of 150
    rounds per rank and r_max 5: the same certified flag, rank and round
    count, f to 1e-6 relative (the JAX package's own test of this driver
    on this file fails on generated data; this compares with its output),
    and on a set without landmarks, where every block optimizes, every
    round's cost to 1e-8;
  * a checkpoint written by either engine loads in the other.

The JAX agents draw their lifting matrices from jax.random; the port takes
them as inputs (`lifting_matrix`), here the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

from dcora_tpu.core import manifold as jmanifold

F_RTOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lift(r):
    return np.asarray(jmanifold.fixed_lifting_matrix(r, 3))


def _compare(rj, rt, f_rtol=F_RTOL):
    assert rt.certified == rj.certified
    assert rt.final_rank == rj.final_rank
    assert rt.total_iters == rj.total_iters
    assert len(rt.cost_trace) == len(rj.cost_trace)
    np.testing.assert_allclose(rt.cost_trace, rj.cost_trace, rtol=f_rtol)
    assert rt.cost_trace[-1] == pytest.approx(rj.cost_trace[-1], rel=f_rtol)


@pytest.mark.parametrize("init", ["Chordal", "Odometry"])
def test_multi_robot_pgo_matches_jax(data_dir, init):
    from dcora_tpu.drivers import multi_robot_pgo as jmr
    from dcora_tpu.types import InitializationMethod as JI
    from dcora_tpu_torch.drivers import multi_robot_pgo as tmr
    from dcora_tpu_torch.types import InitializationMethod as TI

    path = os.path.join(data_dir, "tinyGrid3D.g2o")
    rj = jmr.run(2, path, init_method=JI[init], r_max=8)
    rt = tmr.run(2, path, init_method=TI[init], r_max=8, device="cpu",
                 lifting_matrix=_lift)
    _compare(rj, rt)
    assert rt.certified
    assert rt.X.rot.shape == tuple(np.asarray(rj.X.rot).shape)
    for k in rj.trajectories:
        np.testing.assert_allclose(rt.trajectories[k], rj.trajectories[k],
                                   rtol=0, atol=1e-6)


def _distributed_gnc(data_dir, tmp_path, monkeypatch, port_native):
    """The distributed GNC pipeline (weight updates, adaptive mu, budget
    extension) on smallGrid3D with planted outliers, in both engines (the
    JAX package on its default host path; the port on its native or its
    numpy reader and Jacobi build).  Checks what does not depend on the
    last digits and returns the two per-round cost traces up to the first
    weight update's round."""
    import dcora_tpu_torch.native as tnative
    from dcora_tpu import datasets as jds
    from dcora_tpu.drivers import multi_robot_pgo as jmr
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.types import InitializationMethod as JI
    from dcora_tpu.types import RobustCostParameters as JRP
    from dcora_tpu.types import RobustCostType as JRT
    from dcora_tpu_torch.drivers import multi_robot_pgo as tmr
    from dcora_tpu_torch.types import InitializationMethod as TI
    from dcora_tpu_torch.types import RobustCostParameters as TRP
    from dcora_tpu_torch.types import RobustCostType as TRT

    ds = read_g2o_file(os.path.join(data_dir, "smallGrid3D.g2o"))
    corrupted, _ = jds.corrupt_with_outliers(ds.pose_pose_measurements,
                                             frac=0.1, seed=7)
    path = jds.write_g2o(str(tmp_path / "c.g2o"), corrupted, ds.dim)
    kw = dict(num_iters=120, r_max=5, robust_inner_iters=10,
              robust_weight_updates=3)
    rj = jmr.run(3, path, init_method=JI.Chordal,
                 robust_cost_params=JRP(costType=JRT.GNC_TLS), **kw)
    if port_native:
        assert tnative.available()
    else:
        monkeypatch.setattr(tnative, "get_library", lambda: None)
    rt = tmr.run(3, path, init_method=TI.Chordal,
                 robust_cost_params=TRP(costType=TRT.GNC_TLS),
                 device="cpu", lifting_matrix=_lift, **kw)
    assert rt.certified == rj.certified
    assert rt.final_rank == rj.final_rank
    assert rt.total_iters == rj.total_iters
    assert rt.cost_trace[-1] == pytest.approx(rj.cost_trace[-1], rel=1e-3)
    assert rt.weights.keys() == rj.weights.keys()
    wj = np.array([rj.weights[k] for k in sorted(rj.weights)])
    wt = np.array([rt.weights[k] for k in sorted(rj.weights)])
    assert (wj < 0.5).any()  # the weight updates ran
    np.testing.assert_array_equal(wt < 0.5, wj < 0.5)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-4)
    first = 5 * kw["robust_inner_iters"]  # the first update's round
    return rt.cost_trace[:first], rj.cost_trace[:first]


def test_distributed_gnc_matches_jax(data_dir, tmp_path, monkeypatch):
    """The port on its numpy reader and Jacobi build: every round up to
    the first weight update within 1e-7.  The gate comes from the spread
    of each engine against itself (tests/gnc_host_path_spread.py traces /
    spread, seed 7, an 8-core host): the JAX package moves with XLA's CPU
    threading (default against --xla_cpu_multi_thread_eigen=false
    intra_op_parallelism_threads=1) by 1.35e-8 on its native host path and
    5.2e-9 on its numpy one, and its two host paths land 5.2e-9 (default
    threading) to 2.13e-8 (across threadings) apart; the port's two host
    paths land 1.38e-8 apart, and its torch thread count (1 or 4) moves
    nothing.  The port's numpy path lies 1.53e-8 from JAX's default run and
    2.87e-8 from its one-thread run, so the earlier gate of 1e-8 (F_RTOL)
    held or failed with the host's threading.  1e-7 is about five times
    the largest spread of an engine against itself (2.13e-8)."""
    ct, cj = _distributed_gnc(data_dir, tmp_path, monkeypatch, False)
    np.testing.assert_allclose(ct, cj, rtol=1e-7)


def test_distributed_gnc_native_matches_jax(data_dir, tmp_path,
                                            monkeypatch):
    """The same on the port's default host path, the native reader and
    Jacobi build (bit for bit the JAX package's, test_torch_native.py).
    The gate comes from the spread of each engine against itself
    (tests/gnc_host_path_spread.py, PERF.md §6): at this seed the
    JAX package's native and numpy paths (inputs and preconditioners
    apart in the last ulps) land 5.2e-9 apart in these rounds, the
    port's 8.1e-9, and port native against JAX native 1.23e-8; at seeds
    8-11 the JAX package's own two paths land 2e-6 to 1.2e-2 apart, since
    the weight updates amplify rounding.  The gate, 5e-8, is about four
    times the engines' gap at this seed."""
    ct, cj = _distributed_gnc(data_dir, tmp_path, monkeypatch, True)
    np.testing.assert_allclose(ct, cj, rtol=5e-8)


def test_multi_robot_raslam_matches_jax(data_dir):
    from dcora_tpu.drivers import multi_robot_raslam as jra
    from dcora_tpu_torch.drivers import multi_robot_raslam as tra

    path = os.path.join(data_dir, "range_aided_slam_test_3d.pyfg")
    kw = dict(num_iters=150, r_max=5, min_eig_num_tol=1e-3,
              rgrad_norm_tol=0.1)
    rj = jra.run(path, **kw)
    rt = tra.run(path, device="cpu", lifting_matrix=_lift, **kw)
    _compare(rj, rt, f_rtol=1e-6)
    assert rt.X.r == rj.X.r


def test_multi_robot_raslam_without_landmarks_matches_jax(tmp_path):
    """DCORA on a set whose robots range to each other only, so that every
    block optimizes (each agent's restricted problem holds neighbor slots,
    which the JAX package's gathers clamp onto the zero pad)."""
    from dcora_tpu import datasets as jds
    from dcora_tpu.drivers import multi_robot_raslam as jra
    from dcora_tpu_torch.drivers import multi_robot_raslam as tra

    path = jds.generate_ra_slam_pyfg(
        str(tmp_path / "nl.pyfg"), num_robots=3, poses_per_robot=20,
        num_landmarks=0, range_prob=1.0, rot_noise=0.01, trans_noise=0.01,
        range_noise=0.01, seed=3)
    kw = dict(num_iters=60, r_max=4)
    rj = jra.run(path, **kw)
    rt = tra.run(path, device="cpu", lifting_matrix=_lift, **kw)
    _compare(rj, rt)
    assert rt.cost_trace[-1] < 1e-2 * rt.cost_trace[0]


def test_checkpoint_round_trip_between_engines(tmp_path):
    from dcora_tpu.core.lifted import RAState as JState
    from dcora_tpu.utils import checkpoint as jck
    from dcora_tpu_torch.core.lifted import RAState as TState
    from dcora_tpu_torch.utils import checkpoint as tck

    rng = np.random.default_rng(0)
    arrs = (rng.standard_normal((6, 5, 3)), rng.standard_normal((2, 5)),
            rng.standard_normal((8, 5)))
    w = {"pp": rng.uniform(size=7)}
    extra = {"iteration": 12}
    import jax.numpy as jnp

    for writer, reader in ((jck, tck), (tck, jck)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.npz")
        X = (JState(*(jnp.asarray(a) for a in arrs)) if writer is jck
             else TState(*(torch.as_tensor(a) for a in arrs)))
        writer.save_checkpoint(path, X, 5, weights=w, extra=extra)
        kw = {"device": "cpu"} if reader is tck else {}
        Xr, rank, wr, er = reader.load_checkpoint(path, **kw)
        assert rank == 5
        for a, b in zip(Xr, arrs):
            np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(wr["pp"], w["pp"])
        assert int(er["iteration"]) == 12
        assert not os.path.exists(path + ".tmp.npz")


def test_multi_robot_pgo_checkpoint_resume(data_dir, tmp_path):
    """The driver writes a checkpoint per escape and resumes from it."""
    from dcora_tpu_torch.drivers import multi_robot_pgo as tmr
    from dcora_tpu_torch.types import InitializationMethod as TI
    from dcora_tpu_torch.utils.checkpoint import load_checkpoint

    path = os.path.join(data_dir, "tinyGrid3D.g2o")
    ck = str(tmp_path / "mr.npz")
    res = tmr.run(2, path, init_method=TI.Random, r_min=3, r_max=6,
                  device="cpu", checkpoint_path=ck,
                  generator=torch.Generator().manual_seed(1))
    X, r, _, _ = load_checkpoint(ck)
    assert r == res.final_rank > 3 and X.r == r
    res2 = tmr.run(2, path, init_method=TI.Random, r_min=3, r_max=6,
                   device="cpu", checkpoint_path=ck)
    assert res2.final_rank >= r and res2.certified
