"""Write tests/data/torch_port_{pgo,ra,robust}_reference.json from the JAX
package.

The PyTorch port (dcora_tpu_torch) is held to the certified rank and f* that
the JAX reference reaches on the same generated pose graphs and RA-SLAM
sets.  The machine that runs the port has no JAX, so this script records
the reference values once, on the CPU:

    DCORA_PLATFORM=cpu JAX_PLATFORMS=cpu python tests/make_torch_port_reference.py [NAME ...]

Each entry names its generator call, so the consumer (chip_smoke.py)
regenerates a bit-identical file from the same seed, and records its CPU
seconds.  The 10,648-pose grid takes roughly twelve minutes on a CPU and
the 500-pose RA set about seven; run them in the background.  The robust
and multi-robot cases (gnc2500, gnc2500_dist, gnc2500_agent, mr_smallGrid3D,
mr_ra500, mr_ra500_nl) go to torch_port_robust_reference.json with the lifting matrices
the JAX agents draw from jax.random, which the port takes as inputs.  The
synchronous-parallel RBCD cases (par_grid10k, par_ra500_nl, par_ra10k_nl:
the central cost after every round, per backend) go to
torch_port_parallel_reference.json.  The tools' cases (tool_g2o512: the
steps of tools/g2o100k_certify.py on an 8^3 grid of its generator;
parity_tinyGrid3D and parity_ra_slam_test_3d: tools/parity.run_config on
the generated test sets) go to torch_port_tools_reference.json (about a
minute in all).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from dcora_tpu_torch.tools.common import RA_KW  # noqa: E402
from dcora_tpu_torch.tools.robust_bench import (  # noqa: E402
    DIST_KW,
    DIST_ROBUST,
    GNC_CORRUPT,
    GNC_GRID,
)

# the cuts of the multi-robot RA runs (solve_mr_ra): at r_max 4 DCORA
# optimizes rank 3 only (``while r < r_max``)
MR_RA_CUT = dict(num_iters=100, r_max=4)
MR_RA_NL_CUT = dict(num_iters=200, r_max=4)
# the cut of the distributed GNC: RBCD rounds per rank (the JAX tool runs
# 12,000, and needed ~84,000 rounds in all on sphere2500), r_max (the
# tool's 10) and the inner budget of a weight update (the tool's 150), so
# that the first weight update runs at round 30 (five times the inner
# budget), while the two engines' iterates still agree to ~1e-13: on the
# corrupted grid the RBCD's discrete decisions part them from round 33 on
DIST_CUT = dict(rounds_per_rank=32, r_max=5, robust_inner_iters=6)

OUT = os.path.join(HERE, "data", "torch_port_pgo_reference.json")
OUT_RA = os.path.join(HERE, "data", "torch_port_ra_reference.json")
OUT_ROBUST = os.path.join(HERE, "data", "torch_port_robust_reference.json")
OUT_PARALLEL = os.path.join(HERE, "data",
                            "torch_port_parallel_reference.json")
OUT_TOOLS = os.path.join(HERE, "data", "torch_port_tools_reference.json")

# name -> (generator function name, keyword arguments)
CASES = {
    "smallGrid3D": ("generate_grid_g2o",
                    dict(shape=[5, 5, 5], rot_noise=0.05, trans_noise=0.02,
                         seed=12)),
    "grid10k": ("generate_large_scale_g2o", dict(target_poses=10_000)),
    "ra500": ("generate_ra_slam_pyfg", dict(RA_KW, poses_per_robot=100)),
    "ra10k": ("generate_ra_slam_pyfg", dict(RA_KW, poses_per_robot=1950)),
    # robust and multi-robot (OUT_ROBUST)
    "gnc2500": ("generate_grid_g2o", dict(GNC_GRID, shape=[10, 10, 25])),
    "gnc2500_dist": ("generate_grid_g2o", dict(GNC_GRID, shape=[10, 10, 25])),
    "gnc2500_agent": ("generate_grid_g2o",
                      dict(GNC_GRID, shape=[10, 10, 25])),
    "mr_smallGrid3D": ("generate_grid_g2o",
                       dict(shape=[5, 5, 5], rot_noise=0.05,
                            trans_noise=0.02, seed=12)),
    "mr_ra500": ("generate_ra_slam_pyfg", dict(RA_KW, poses_per_robot=100)),
    "mr_ra500_nl": ("generate_ra_slam_pyfg",
                    dict(RA_KW, poses_per_robot=100, num_landmarks=0)),
    # synchronous-parallel RBCD (OUT_PARALLEL)
    "par_grid10k": ("generate_large_scale_g2o", dict(target_poses=10_000)),
    "par_ra500_nl": ("generate_ra_slam_pyfg",
                     dict(RA_KW, poses_per_robot=100, num_landmarks=0)),
    "par_ra10k_nl": ("generate_ra_slam_pyfg",
                     dict(RA_KW, poses_per_robot=1950, num_landmarks=0)),
    # the tools (OUT_TOOLS)
    "tool_g2o512": ("generate_large_scale_g2o", dict(target_poses=512)),
    "parity_tinyGrid3D": ("generate_grid_g2o",
                          dict(shape=[2, 2, 2], rot_noise=0.05,
                               trans_noise=0.02, seed=11)),
    "parity_ra_slam_test_3d": ("generate_ra_slam_pyfg", {}),
}
ROBUST = ("gnc2500", "gnc2500_dist", "gnc2500_agent", "mr_smallGrid3D",
          "mr_ra500", "mr_ra500_nl")
LIFT_RANKS = range(3, 13)  # the lifting matrices recorded (d = 3)
RA_R_MAX = 20
RA_ETA = 1e-4  # min_eig_tol of single_robot_raslam.run and the witness


def solve(path: str):
    """The certify branch of dcora_tpu.drivers.single_robot_pgo.run, with
    the staircase result kept (run() returns only the trajectory and f)."""
    from dcora_tpu.core import lifted, problem as prob
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.init import chordal_initialization
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.staircase import riemannian_staircase
    from dcora_tpu.types import ROptParameters
    from dcora_tpu.verification import verify_solution

    ds = read_g2o_file(path)
    ms = ds.pose_pose_measurements
    d = ds.dim
    params = ROptParameters(gradnorm_tol=1e-4, RTR_iterations=200,
                            RTR_tCG_iterations=200)
    g = LocalGraph(0, d + 2, d)
    g.set_measurements(ms)
    T = chordal_initialization(ms)
    X0 = lifted.pad_rank(lifted.from_pose_array(T), d + 2)
    res = riemannian_staircase(g, X0, r_min=d + 2, r_max=20,
                               opt_params=params, min_eig_num_tol=1e-3)
    f = float(prob.cost(g.problem_data(), res.rounded))
    rep = verify_solution(ms, res.X, d, eta=1e-3)
    return dict(n=g.n, m=len(ms), certified=bool(res.certified),
                rank=int(res.final_rank), f=f,
                f_lifted=float(res.f_final),
                ldl_witness=bool(rep["certified_indep"]))


# the JAX g2o100k tool's parameters (tools/g2o100k_certify.py)
TOOL_G2O = dict(rmin=5, rmax=8, tcg=50, eta=1e-3)


def solve_g2o100k_tool(path: str):
    """The body of the JAX package's tools/g2o100k_certify.py on `path`:
    the staircase at its budget, then S's host assembly, the LDL^T proof,
    the host min-eig path and the independent verifier."""
    import scipy.sparse as sp

    from dcora_tpu.core import lifted
    from dcora_tpu.core.certify import (
        _assemble_S_host, _min_eig_host, dual_certificate_blocks,
        ldl_psd_proof)
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.init import chordal_initialization
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.staircase import riemannian_staircase
    from dcora_tpu.types import ROptParameters
    from dcora_tpu.verification import verify_solution

    t = TOOL_G2O
    ms = read_g2o_file(path).pose_pose_measurements
    g = LocalGraph(0, t["rmin"], 3)
    g.set_measurements(ms)
    X0 = lifted.pad_rank(lifted.from_pose_array(
        chordal_initialization(ms)), t["rmin"])
    res = riemannian_staircase(
        g, X0, r_min=t["rmin"], r_max=t["rmax"],
        opt_params=ROptParameters(gradnorm_tol=1e-4, RTR_iterations=200,
                                  RTR_tCG_iterations=t["tcg"]),
        min_eig_num_tol=t["eta"])
    P = g.problem_data()
    C = dual_certificate_blocks(P, res.X)
    dims = res.X.dims
    S = _assemble_S_host(P, C, dims)
    cert_host, theta, _ = _min_eig_host(P, C, dims, t["eta"])
    rec = dict(params=t, certified=bool(res.certified),
               final_rank=int(res.final_rank), f_final=float(res.f_final),
               k=int(dims.k), S_nnz=int(S.nnz),
               ldl_proof=ldl_psd_proof(
                   S + t["eta"] * sp.identity(dims.k, format="csr")),
               min_eig_host_certified=bool(cert_host),
               min_eig_host_theta=float(theta))
    rec.update(verify_solution(ms, res.X, 3, eta=t["eta"]))
    return rec


def solve_parity(name: str, path: str):
    """tools/parity.run_config of the JAX package on the config `name`
    (its file at `path`), its checkpoint and final state kept in a
    temporary directory."""
    import shutil

    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    import parity

    import dcora_tpu.drivers.single_robot_raslam as jdriver

    config = name[len("parity_"):]
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(path, os.path.join(tmp, parity.CONFIGS[config]["file"]))
        real = jdriver.run
        jdriver.run = lambda *a, checkpoint_path=None, **kw: real(
            *a, checkpoint_path=os.path.join(tmp, "ckpt.npz"), **kw)
        state_dir, parity.STATE_DIR = parity.STATE_DIR, tmp
        try:
            rec = parity.run_config(config, tmp)
        finally:
            jdriver.run, parity.STATE_DIR = real, state_dir
    return {k: v for k, v in rec.items()
            if k not in ("timestamp", "elapsed_s", "verify_indep_s")}


def solve_ra(path: str):
    """dcora_tpu.drivers.single_robot_raslam.run with its defaults (odometry
    init, r_max 20, eta 1e-4), plus the independent LDL^T witness."""
    from dcora_tpu.core import problem as prob
    from dcora_tpu.drivers.single_robot_raslam import run
    from dcora_tpu.verification import verify_solution

    res, g, gm = run(path, r_max=RA_R_MAX, min_eig_tol=RA_ETA, verbose=False)
    f = float(prob.cost(g.problem_data(), res.rounded))
    rep = verify_solution(gm.relative_measurements, res.X, g.d, eta=RA_ETA)
    return dict(n=g.n, l=g.dims.l, b=g.dims.b,
                m=len(gm.relative_measurements),
                certified=bool(res.certified), rank=int(res.final_rank),
                f=f, f_lifted=float(res.f_final),
                gradnorm=float(res.gradnorm_final),
                ldl_witness=bool(rep["certified_indep"]),
                gradnorm_indep=float(rep["gradnorm_indep"]),
                r_max=RA_R_MAX, eta=RA_ETA)


def _classes(weights, outliers):
    from dcora_tpu_torch.tools.robust_bench import classification

    return classification(weights, outliers)


def solve_gnc(path: str):
    """solveRobustPGO on the corrupted set at the parameters of
    dcora_tpu.drivers.single_robot_gnc.run, and the JAX verifier on the
    clean problem at its trajectory."""
    from dcora_tpu import datasets
    from dcora_tpu.core import lifted
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.solvers import SolveRobustPGOParams, solve_robust_pgo
    from dcora_tpu.types import (ROptParameters, RobustCostParameters,
                                 RobustCostType)
    from dcora_tpu.verification import verify_solution

    ds = read_g2o_file(path)
    clean = ds.pose_pose_measurements
    corrupted, outliers = datasets.corrupt_with_outliers(clean,
                                                         **GNC_CORRUPT)
    T = solve_robust_pgo(corrupted, SolveRobustPGOParams(
        opt_params=ROptParameters(gradnorm_tol=1e-2, RTR_iterations=50),
        robust_params=RobustCostParameters(
            costType=RobustCostType.GNC_TLS)))
    weights = {(m.p1, m.p2): m.weight for m in corrupted
               if not m.fixedWeight}
    X = lifted.from_pose_array(T)
    weighted = verify_solution(corrupted, X, ds.dim, eta=1e-3)
    for m in clean:
        m.weight = 1.0
    rep = verify_solution(clean, X, ds.dim, eta=1e-3)
    return dict(n=ds.num_poses, edges=len(clean), outliers=len(outliers),
                rejected=sorted([list(k) for k, w in weights.items()
                                 if w < 1e-8]),
                weights={f"{k[0]},{k[1]}": float(w)
                         for k, w in sorted(weights.items())},
                f_weighted=float(weighted["f_indep"]),
                gradnorm_weighted=float(weighted["gradnorm_indep"]),
                classification=_classes(weights, outliers),
                f_on_clean=float(rep["f_indep"]),
                gradnorm_on_clean=float(rep["gradnorm_indep"]),
                certified_on_clean=bool(rep["certified_indep"]))


def solve_gnc_dist(path: str):
    """dcora_tpu.drivers.multi_robot_pgo.run with GNC-TLS at the JAX tool's
    parameters, cut to DIST_CUT."""
    from dcora_tpu import datasets
    from dcora_tpu.drivers.multi_robot_pgo import run
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.types import (InitializationMethod, RobustCostParameters,
                                 RobustCostType)

    ds = read_g2o_file(path)
    corrupted, outliers = datasets.corrupt_with_outliers(
        ds.pose_pose_measurements, **GNC_CORRUPT)
    cpath = datasets.write_g2o(path + ".corrupted.g2o", corrupted, ds.dim)
    res = run(5, cpath, num_iters=DIST_CUT["rounds_per_rank"],
              init_method=InitializationMethod.Chordal,
              robust_cost_params=RobustCostParameters(
                  costType=RobustCostType.GNC_TLS, **DIST_ROBUST),
              **dict(DIST_KW, r_max=DIST_CUT["r_max"],
                     robust_inner_iters=DIST_CUT["robust_inner_iters"]))
    return dict(DIST_CUT, certified=bool(res.certified),
                final_rank=int(res.final_rank),
                total_iters=int(res.total_iters),
                rounds=len(res.cost_trace),
                final_cost=float(res.cost_trace[-1]),
                cost_trace=[float(c) for c in res.cost_trace],
                weights={f"{k[0]},{k[1]}": float(w)
                         for k, w in sorted(res.weights.items())},
                classification=_classes(res.weights, outliers))


def solve_gnc_agent(path: str):
    """One agent's GNC-TLS local initialization (dcora_tpu.agent,
    Agent.cpp:379-418) on robot 0's 500-pose block of the corrupted set."""
    from dcora_tpu import datasets
    from dcora_tpu.agent import Agent
    from dcora_tpu.drivers.multi_robot_pgo import partition_measurements
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.types import AgentParameters, InitializationMethod

    ds = read_g2o_file(path)
    corrupted, _ = datasets.corrupt_with_outliers(ds.pose_pose_measurements,
                                                  **GNC_CORRUPT)
    odo, priv, shared, _ = partition_measurements(corrupted, ds.num_poses, 5)
    a = Agent(0, AgentParameters(
        d=3, r=5, robotIDs=frozenset(range(5)),
        localInitializationMethod=InitializationMethod.GNC_TLS))
    a.set_measurements(odo[0] + priv[0] + shared[0])
    a.initialize()
    T = a.trajectory_local_init
    return dict(n=a.num_poses,
                loop_closures=len(priv[0]),
                rejected=sorted([m.p1, m.p2] for m in priv[0]
                                if m.weight < 1e-8),
                T_sum=float(np.abs(T).sum()))


def solve_mr(path: str):
    """dcora_tpu.drivers.multi_robot_pgo.run, 5 robots, Chordal init, the
    driver's defaults otherwise."""
    from dcora_tpu.drivers.multi_robot_pgo import run
    from dcora_tpu.types import InitializationMethod

    res = run(5, path, init_method=InitializationMethod.Chordal)
    return dict(robots=5, certified=bool(res.certified),
                rank=int(res.final_rank), total_iters=int(res.total_iters),
                rounds=len(res.cost_trace), f=float(res.cost_trace[-1]),
                final_theta=res.final_theta)


def solve_mr_ra(path: str, cut=MR_RA_CUT):
    """dcora_tpu.drivers.multi_robot_raslam.run at its defaults but for
    the cut.  On mr_ra500 (MR_RA_CUT) no robot's block is ever optimized
    (every robot ranges to the landmarks, whose states the map agent never
    shares: the driver gives it no measurements), so the run would climb to
    r_max = 100 at its initial cost.  mr_ra500_nl (MR_RA_NL_CUT) has no
    landmarks, only the ranges between robots, so every block optimizes."""
    from dcora_tpu.drivers.multi_robot_raslam import run

    res = run(path, **cut)
    return dict(cut, certified=bool(res.certified),
                cost_trace=[float(c) for c in res.cost_trace],
                rank=int(res.final_rank),
                total_iters=int(res.total_iters),
                rounds=len(res.cost_trace), f=float(res.cost_trace[-1]),
                gradnorm=float(res.gradnorm_trace[-1]),
                final_theta=res.final_theta)


# the parallel runs: agents, rounds and backends recorded per set (the
# tiled backend at float64 tiles)
PAR_RUNS = {"par_grid10k": dict(agents=8, rounds=30,
                                backends=("edge", "tiled")),
            "par_ra500_nl": dict(rounds=30, backends=("edge", "tiled")),
            "par_ra10k_nl": dict(rounds=10, backends=("edge",))}


def solve_parallel(name: str, path: str):
    """The JAX scaling mode's central cost (2 f, as its drivers print it)
    after each round, from the drivers' init (Chordal for PGO, odometry for
    RA), on a one-device mesh (the JAX dry run shows an n-device mesh gives
    the same blocks): dcora_tpu.drivers.parallel_{pgo,raslam}.run's loop
    at check_every 1, per backend."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dcora_tpu.core import lifted, problem as prob
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.lifted import RAState
    from dcora_tpu.core.rtr import RTRConfig
    from dcora_tpu.parallel import rbcd
    from dcora_tpu.types import GraphType, MAP_ID

    spec = PAR_RUNS[name]
    cfg = RTRConfig(gradnorm_tol=1e-2, max_inner=50,
                    single_accepted_step=True)
    if path.endswith(".g2o"):
        from dcora_tpu.core.init import chordal_initialization
        from dcora_tpu.drivers.multi_robot_pgo import (
            partition_measurements,
            robot_slice,
        )
        from dcora_tpu.io import read_g2o_file

        A, r = spec["agents"], 5
        ds = read_g2o_file(path)
        ms, n, d = ds.pose_pose_measurements, ds.num_poses, ds.dim
        odo, priv, shared, _ = partition_measurements(ms, n, A)
        graphs = []
        for a in range(A):
            g = LocalGraph(a, r, d)
            g.set_measurements(odo[a] + priv[a] + shared[a])
            graphs.append(g)
        X = lifted.pad_rank(lifted.from_pose_array(
            chordal_initialization(ms)), r)
        states = [RAState(rot=X.rot[s:e], sph=X.sph[:0], trn=X.trn[s:e])
                  for s, e in (robot_slice(n, A, a) for a in range(A))]
        central = LocalGraph(0, r, d)
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
            get_robot_measurements,
            robot_global_indices,
        )

        ds = read_pyfg_file(path)
        gm = get_global_measurements(ds)
        rm = get_robot_measurements(ds)
        ridx = robot_global_indices(ds)
        d = r = ds.dim
        active = [rid for rid in sorted(ds.robot_IDs) if rid != MAP_ID]
        A = len(active)
        graphs = []
        for rid in active:
            g = LocalGraph(rid, r, d, GraphType.RangeAidedSLAMGraph)
            g.set_measurements(rm[rid].relative_measurements)
            graphs.append(g)
        X0 = odometry_init_global(ds, gm)
        states = [_slice_agent_state(X0, ridx[rid]) for rid in active]
        gt = gm.ground_truth_init
        central = LocalGraph(0, r, d, GraphType.RangeAidedSLAMGraph)
        central.set_measurements(gm.relative_measurements)

        def glob(pp, Xb):
            out = (np.zeros((gt.n, r, d)), np.zeros((gt.l, r)),
                   np.zeros((gt.n + gt.b, r)))
            for a, part in enumerate(rbcd.unpack_states(pp, Xb)):
                _scatter_agent_state(out, part, ridx[active[a]], gt.n)
            return RAState(*(jnp.asarray(x) for x in out))

    P = central.problem_data()
    mesh = Mesh(np.array(jax.devices()[:1]), ("agents",))
    rec = dict(agents=A, rank=r, rounds=spec["rounds"])
    for backend in spec["backends"]:
        pp = rbcd.build_parallel_problem(graphs, backend=backend,
                                         tile_dtype=np.float64)
        round_fn = rbcd.make_parallel_round(pp, cfg, mesh)
        Xb = rbcd.pack_states(pp, states)
        costs, iterates = [], []
        t0 = time.time()
        for _ in range(spec["rounds"]):
            Xb, _ = round_fn(Xb)
            iterates.append(Xb)
            costs.append(2.0 * float(prob.cost(P, glob(pp, Xb))))
        rec[backend] = dict(cost_trace=costs,
                            seconds=round(time.time() - t0, 1))
        port = np.array(_port_cpu_trace(name, path, backend, spec["rounds"]))
        rec[backend]["port_cpu_rel"] = (np.abs(port - costs)
                                        / np.abs(costs)).tolist()
        if backend == "edge" and path.endswith(".g2o"):
            rec[backend]["jax_alone_round2_rel"] = _jax_alone_spread(
                pp, iterates[0], iterates[1], cfg)
        print(name, backend, costs[0], costs[-1], "port on the CPU: max rel",
              max(rec[backend]["port_cpu_rel"]), flush=True)
    return rec


def _port_cpu_trace(name: str, path: str, backend: str, rounds: int):
    """The port's central cost after each round on the CPU, through its
    driver (dcora_tpu_torch.drivers.parallel_{pgo,raslam}.run)."""
    import torch

    from dcora_tpu_torch.drivers import parallel_pgo, parallel_raslam

    kw = dict(max_rounds=rounds, rgrad_norm_tol=0.0, check_every=1,
              backend=backend, tile_dtype=torch.float64, device="cpu")
    res = (parallel_pgo.run(PAR_RUNS[name]["agents"], path, **kw)
           if path.endswith(".g2o") else parallel_raslam.run(path, **kw))
    return [c for _, c, _ in res.trace]


def _jax_alone_spread(pp, X1, X2, cfg):
    """Per agent, the largest difference (relative to the largest entry)
    between round 2 of the JAX vmapped round (X2, from X1) and the same
    agent's update alone: the same G (its fixed states gathered from X1's
    public buffers as the round does; PGO: every fixed translation is a
    pose's) through dcora_tpu.parallel.rbcd._one_agent_update without
    vmap.  The same arithmetic in another order: what an iterate's
    round-to-round spread is made of."""
    import jax

    from dcora_tpu.core.lifted import RAState
    from dcora_tpu.parallel.rbcd import _one_agent_update

    B = pp.batched
    A = pp.num_agents
    rows = np.arange(A)[:, None]

    def pad(x):
        x = np.asarray(x)
        return np.concatenate([x, np.zeros_like(x[:, :1])], 1)

    pub_rot = pad(X1.rot)[rows, np.asarray(B.pub_pose_idx)]
    pub_ptr = pad(X1.trn)[rows, np.asarray(B.pub_pose_idx)]
    one = jax.jit(_one_agent_update, static_argnames=("cfg", "d"))
    out = []
    for a in range(A):
        fps = np.asarray(B.fix_pose_src[a])
        fts = np.asarray(B.fix_trans_src[a])
        fixed = RAState(rot=pub_rot[fps[:, 0], fps[:, 1]],
                        sph=np.zeros((0, X1.rot.shape[2])),
                        trn=pub_ptr[fts[:, 0], fts[:, 1]])
        sl = jax.tree.map(lambda x: x[a], (B.P, B.P_loc, B.M, X1))
        Xa, _ = one(*sl[:3], sl[3], fixed, cfg, pp.d)
        want = np.asarray(X2.rot[a])
        out.append(float(np.abs(np.asarray(Xa.rot) - want).max()
                         / np.abs(want).max()))
    return out


SOLVERS = {"gnc2500": solve_gnc, "gnc2500_dist": solve_gnc_dist,
           "gnc2500_agent": solve_gnc_agent, "mr_smallGrid3D": solve_mr,
           "mr_ra500": solve_mr_ra,
           "mr_ra500_nl": lambda path: solve_mr_ra(path, MR_RA_NL_CUT)}


def main(names=None):
    import dcora_tpu  # noqa: F401  (x64 on)
    from dcora_tpu import datasets

    with tempfile.TemporaryDirectory() as tmp:
        for name in names or CASES:
            gen, kw = CASES[name]
            ra = gen == "generate_ra_slam_pyfg"
            path = os.path.join(tmp, name + (".pyfg" if ra else ".g2o"))
            call = dict(kw)
            if "shape" in call:
                call["shape"] = tuple(call["shape"])
            getattr(datasets, gen)(path, **call)
            t0 = time.time()
            if name in PAR_RUNS:
                rec, dest = solve_parallel(name, path), OUT_PARALLEL
            elif name == "tool_g2o512":
                rec, dest = solve_g2o100k_tool(path), OUT_TOOLS
            elif name.startswith("parity_"):
                rec, dest = solve_parity(name, path), OUT_TOOLS
            elif name in ROBUST:
                rec, dest = SOLVERS[name](path), OUT_ROBUST
            else:
                rec = (solve_ra if ra else solve)(path)
                dest = OUT_RA if ra else OUT
            rec["generator"] = gen
            rec["kwargs"] = kw
            rec["seconds"] = round(time.time() - t0, 1)
            print(name, {k: v for k, v in rec.items()
                         if k not in ("weights", "rejected", "cost_trace")},
                  flush=True)
            out = {}
            if os.path.exists(dest):  # re-read: another run may have written
                with open(dest) as fh:
                    out = json.load(fh)
            out[name] = rec
            if dest == OUT_ROBUST:
                from dcora_tpu.core.manifold import fixed_lifting_matrix

                out["lifting_matrices"] = {
                    str(r): np.asarray(fixed_lifting_matrix(r, 3)).tolist()
                    for r in LIFT_RANKS}
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "w") as fh:
                json.dump(out, fh, indent=1, sort_keys=True)
                fh.write("\n")


if __name__ == "__main__":
    np.set_printoptions(precision=12)
    main(sys.argv[1:] or None)
