"""Shared helpers for the port-vs-reference tests (tests/test_torch_*.py).

Inputs are made from a seed with numpy and fed to both engines: the JAX
package (dcora_tpu) and the PyTorch port (dcora_tpu_torch, through
dcora_tpu_torch.convert).  Tolerances:

  * F64_RTOL: f64 operators agree to 1e-10 relative (the port's bar);
  * F32_ATOL: the f32 tile path agrees to 2e-6 of max|W| (the bar of
    tests/test_tiled.py for the Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

import dcora_tpu.core.graph as jgraph
import dcora_tpu.measurements as jmeas
import dcora_tpu.types as jtypes
import dcora_tpu_torch.core.graph as tgraph
import dcora_tpu_torch.measurements as tmeas
import dcora_tpu_torch.types as ttypes
from dcora_tpu.datasets import _rand_rotation

F64_RTOL = 1e-10
F32_ATOL = 2e-6


def np_of(x) -> np.ndarray:
    """Host float64/int array of a jax array, torch tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(a, b, rtol=F64_RTOL, scale=None):
    """|a - b| <= rtol * max(|b|) elementwise (scale-relative)."""
    a, b = np_of(a), np_of(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    s = scale if scale is not None else max(float(np.abs(b).max(initial=0)),
                                            1e-300)
    err = float(np.abs(a - b).max(initial=0)) / s
    assert err <= rtol, f"relative error {err:.3e} > {rtol:.1e}"


def assert_segments_equal(a, b):
    """Two problem.Segments (the port's segment maps) are identical."""
    for ma, mb in zip(a, b):
        assert ma.bounds == mb.bounds
        for x, y in ((ma.idx, mb.idx), (ma.perm, mb.perm), (ma.ptr, mb.ptr)):
            assert x.dtype == y.dtype and torch.equal(x, y)


def assert_state_close(A, B, rtol=F64_RTOL):
    scale = max(float(np.abs(np_of(x)).max(initial=0)) for x in B)
    for a, b in zip(A, B):
        assert_close(a, b, rtol, scale=max(scale, 1e-300))


def random_graph_spec(rng, n=7, l=4, b=3, d=3):  # noqa: E741
    """A measurement list with every type, random weights, as plain dicts
    (the tests/test_tiled.py:32-61 graph, drawn with numpy only)."""
    spec = []
    for i in range(n - 1):
        spec.append(("pp", dict(r1=0, p1=i, r2=0, p2=i + 1,
                                R=_rand_rotation(rng, np.pi),
                                t=rng.standard_normal(d),
                                kappa=rng.uniform(1, 5),
                                tau=rng.uniform(1, 5),
                                weight=rng.uniform(0.3, 1.0))))
    for _ in range(2):  # loop closures
        i, j = sorted(rng.choice(n, size=2, replace=False))
        if j > i + 1:
            spec.append(("pp", dict(r1=0, p1=int(i), r2=0, p2=int(j),
                                    R=_rand_rotation(rng, np.pi),
                                    t=rng.standard_normal(d),
                                    kappa=rng.uniform(1, 5),
                                    tau=rng.uniform(1, 5),
                                    weight=rng.uniform(0.3, 1.0))))
    for j in range(b):
        spec.append(("pl", dict(r1=0, p1=int(rng.integers(n)), r2=0, p2=j,
                                t=rng.standard_normal(d),
                                tau=rng.uniform(1, 5),
                                weight=rng.uniform(0.3, 1.0))))
    for q in range(l):
        i = int(rng.integers(n))
        j = int(rng.integers(b)) if b else int(rng.integers(n))
        spec.append(("rg", dict(r1=0, p1=i, r2=0, p2=j,
                                land=bool(b), l=q,
                                range=float(rng.uniform(0.5, 3.0)),
                                precision=rng.uniform(1, 5),
                                weight=rng.uniform(0.3, 1.0))))
    return spec


def _measurements(spec, M, Ty):
    out = []
    for kind, kw in spec:
        kw = dict(kw)
        if kind == "pp":
            out.append(M.RelativePosePoseMeasurement(**kw))
        elif kind == "pl":
            out.append(M.RelativePoseLandmarkMeasurement(**kw))
        else:
            land = kw.pop("land")
            st2 = Ty.StateType.Landmark if land else Ty.StateType.Pose
            out.append(M.RangeMeasurement(
                kw["r1"], kw["p1"], kw["r2"], kw["p2"], Ty.StateType.Pose,
                st2, kw["l"], kw["range"], precision=kw["precision"],
                weight=kw["weight"]))
    return out


def build_graphs(spec, d=3, r=None, prior=True):
    """(JAX LocalGraph, port LocalGraph) over the same measurements, each
    with the same pose-0 prior."""
    r = d if r is None else r
    graphs = []
    for G, M, Ty in ((jgraph, jmeas, jtypes), (tgraph, tmeas, ttypes)):
        g = G.LocalGraph(0, r, d)
        g.set_measurements(_measurements(spec, M, Ty))
        if prior:
            P0 = np.zeros((r, d + 1))
            P0[:d, :d] = np.eye(d)
            g.set_prior(0, P0)
        graphs.append(g)
    return graphs


def random_state_arrays(rng, dims, r):
    """(rot, sph, trn) numpy arrays of a random point on the manifold."""
    A = rng.standard_normal((dims.n, r, dims.d))
    U, _, Vt = np.linalg.svd(A, full_matrices=False)
    rot = U @ Vt
    sph = rng.standard_normal((dims.l, r))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    trn = rng.standard_normal((dims.num_trans, r))
    return rot, sph, trn


def jax_state(arrs):
    import jax.numpy as jnp
    from dcora_tpu.core.lifted import RAState

    return RAState(*(jnp.asarray(a) for a in arrs))


def torch_state(arrs, device="cpu"):
    from dcora_tpu_torch.core.lifted import RAState

    return RAState(*(torch.as_tensor(a, dtype=torch.float64, device=device)
                     for a in arrs))


# --------------------------------------------------------------------------
# The parallel RBCD tests (tests/test_torch_parallel*.py): 4 agents of the
# generated smallGrid3D set, and a generated 48-pose PyFG set without
# landmarks (4 robots that range to each other)
# --------------------------------------------------------------------------

PAR_AGENTS = 4
PAR_RA_KW = dict(num_robots=4, poses_per_robot=12, num_landmarks=0,
                 range_prob=0.6, rot_noise=0.01, trans_noise=0.01,
                 range_noise=0.01, seed=3)


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max(initial=0)) / max(
        float(np.abs(b).max(initial=0)), 1e-300)


def parallel_pgo_graphs(engine, path, r=5):
    if engine == "jax":
        from dcora_tpu.core.graph import LocalGraph
        from dcora_tpu.drivers.multi_robot_pgo import partition_measurements
        from dcora_tpu.io import read_g2o_file
    else:
        from dcora_tpu_torch.core.graph import LocalGraph
        from dcora_tpu_torch.drivers.multi_robot_pgo import (
            partition_measurements,
        )
        from dcora_tpu_torch.io import read_g2o_file
    ds = read_g2o_file(path)
    ms = ds.pose_pose_measurements
    odo, priv, shared, _ = partition_measurements(ms, ds.num_poses, PAR_AGENTS)
    graphs = []
    for a in range(PAR_AGENTS):
        g = LocalGraph(a, r, ds.dim)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)
    return graphs


def parallel_ra_graphs(engine, path):
    if engine == "jax":
        from dcora_tpu.core.graph import LocalGraph
        from dcora_tpu.io import read_pyfg_file
        from dcora_tpu.io.remap import get_robot_measurements
        from dcora_tpu.types import GraphType, MAP_ID
    else:
        from dcora_tpu_torch.core.graph import LocalGraph
        from dcora_tpu_torch.io import read_pyfg_file
        from dcora_tpu_torch.io.remap import get_robot_measurements
        from dcora_tpu_torch.types import GraphType, MAP_ID
    ds = read_pyfg_file(path)
    rm = get_robot_measurements(ds)
    graphs = []
    for rid in sorted(ds.robot_IDs):
        if rid == MAP_ID:
            continue
        g = LocalGraph(rid, ds.dim, ds.dim, GraphType.RangeAidedSLAMGraph)
        g.set_measurements(rm[rid].relative_measurements)
        graphs.append(g)
    return graphs


class JaxParallelRun:
    """The JAX package's edge rounds from the driver's init, with the
    driver's central cost (2 f) after every round."""

    def __init__(self, kind, path, rounds):
        import jax.numpy as jnp
        from jax.sharding import Mesh
        import jax

        from dcora_tpu.core import lifted, problem as prob
        from dcora_tpu.core.graph import LocalGraph
        from dcora_tpu.core.lifted import RAState
        from dcora_tpu.core.rtr import RTRConfig
        from dcora_tpu.parallel import rbcd

        cfg = RTRConfig(gradnorm_tol=1e-2, max_inner=50,
                        single_accepted_step=True)
        if kind == "pgo":
            from dcora_tpu.core.init import chordal_initialization
            from dcora_tpu.drivers.multi_robot_pgo import robot_slice
            from dcora_tpu.io import read_g2o_file

            graphs = parallel_pgo_graphs("jax", path)
            ds = read_g2o_file(path)
            ms, n, r = ds.pose_pose_measurements, ds.num_poses, 5
            X = lifted.pad_rank(lifted.from_pose_array(
                chordal_initialization(ms)), r)
            states = [RAState(rot=X.rot[s:e], sph=X.sph[:0], trn=X.trn[s:e])
                      for s, e in (robot_slice(n, PAR_AGENTS, a)
                                   for a in range(PAR_AGENTS))]
            central = LocalGraph(0, r, ds.dim)
            central.set_measurements(ms)

            def glob(pp, Xb):
                parts = rbcd.unpack_states(pp, Xb)
                return RAState(rot=jnp.concatenate([s.rot for s in parts]),
                               sph=jnp.zeros((0, r)),
                               trn=jnp.concatenate([s.trn for s in parts]))
        else:
            from dcora_tpu.drivers.multi_robot_raslam import (
                _scatter_agent_state,
                _slice_agent_state,
            )
            from dcora_tpu.drivers.single_robot_raslam import (
                odometry_init_global,
            )
            from dcora_tpu.io import read_pyfg_file
            from dcora_tpu.io.remap import (
                get_global_measurements,
                robot_global_indices,
            )
            from dcora_tpu.types import GraphType, MAP_ID

            graphs = parallel_ra_graphs("jax", path)
            ds = read_pyfg_file(path)
            gm = get_global_measurements(ds)
            ridx = robot_global_indices(ds)
            active = [rid for rid in sorted(ds.robot_IDs) if rid != MAP_ID]
            X0 = odometry_init_global(ds, gm)
            states = [_slice_agent_state(X0, ridx[rid]) for rid in active]
            gt = gm.ground_truth_init
            r = ds.dim
            central = LocalGraph(0, r, ds.dim,
                                 GraphType.RangeAidedSLAMGraph)
            central.set_measurements(gm.relative_measurements)

            def glob(pp, Xb):
                out = (np.zeros((gt.n, r, ds.dim)), np.zeros((gt.l, r)),
                       np.zeros((gt.n + gt.b, r)))
                for a, part in enumerate(rbcd.unpack_states(pp, Xb)):
                    _scatter_agent_state(out, part, ridx[active[a]], gt.n)
                return RAState(*(jnp.asarray(x) for x in out))

        self.pp = rbcd.build_parallel_problem(graphs)
        mesh = Mesh(np.array(jax.devices()[:1]), ("agents",))
        round_fn = rbcd.make_parallel_round(self.pp, cfg, mesh)
        P = central.problem_data()
        self.X0 = rbcd.pack_states(self.pp, states)
        Xb, self.states, self.costs = self.X0, [], []
        for _ in range(rounds):
            Xb, _ = round_fn(Xb)
            self.states.append(Xb)
            self.costs.append(2.0 * float(prob.cost(P, glob(self.pp, Xb))))


def torch_parallel_problem(kind, path):
    """The port's ParallelRBCDProblem of the "pgo" or the "ra" set."""
    from dcora_tpu_torch.parallel.rbcd import build_parallel_problem

    graphs = (parallel_pgo_graphs("torch", path) if kind == "pgo"
              else parallel_ra_graphs("torch", path))
    return build_parallel_problem(graphs)


def parallel_paths(data_dir, tmp_dir):
    """{"pgo": smallGrid3D, "ra": the landmark-free PyFG set (made in
    tmp_dir)}."""
    import os

    from dcora_tpu_torch import datasets

    return dict(pgo=os.path.join(data_dir, "smallGrid3D.g2o"),
                ra=datasets.generate_ra_slam_pyfg(
                    os.path.join(tmp_dir, "ra_nl.pyfg"), **PAR_RA_KW))
