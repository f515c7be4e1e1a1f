"""Multi-process dry run of the parallel RBCD round over torch.distributed.

Counterpart of ``__graft_entry__.dryrun_multichip``: N processes, one rank
each, share the agents of one problem (two per rank) and run its rounds
with the separator exchange as an all_gather over the group.  It checks

  * 4 rounds of the generated tinyGrid3D set (edge path) with a monotone
    central cost;
  * that the N-rank round equals the one-process round (no group) to 1e-12;
  * the certificate's S matvec over A edge shards, each rank applying its
    own and an all_reduce adding them, equal to the central apply_S (1e-12
    of max|S v|);
  * a round of the tiled path (every agent's tile products in one launch
    per product on the card);
  * a round of the RA path on a generated set without landmarks (the JAX
    dry run's num_landmarks=0: the parallel RA mode cannot run a set with
    landmarks; with noise 0.01, so that the round has work to do), with
    unit spheres among the separators.

    python -m dcora_tpu_torch.tools.dryrun_multichip N [--device cuda|cpu]

On cuda the group is NCCL and rank i uses card i (N cards); on the CPU it is
gloo.  Each rank runs in its own process with its own time limit, and every
process is stopped before the tool returns.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TIMEOUT_S = 600
AGENTS_PER_RANK = 2
ROUND_TOL = 1e-12


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _say(rank: int, msg: str):
    if rank == 0:
        print(msg, flush=True)


def worker(rank: int, world: int, url: str, device: str, data: str):
    from dcora_tpu_torch.core import lifted, problem as prob
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.core.init import chordal_initialization
    from dcora_tpu_torch.core.lifted import RAState
    from dcora_tpu_torch.drivers.multi_robot_pgo import (
        partition_measurements,
        robot_slice,
    )
    from dcora_tpu_torch.drivers.multi_robot_raslam import _slice_agent_state
    from dcora_tpu_torch.drivers.parallel_pgo import ROUND_CFG
    from dcora_tpu_torch.drivers.single_robot_raslam import (
        odometry_init_global,
    )
    from dcora_tpu_torch.io import read_g2o_file, read_pyfg_file
    from dcora_tpu_torch.io.remap import (
        get_global_measurements,
        get_robot_measurements,
        robot_global_indices,
    )
    from dcora_tpu_torch.parallel.rbcd import (
        ParallelRound,
        build_parallel_problem,
        init_group,
        pack_states,
    )
    from dcora_tpu_torch.types import GraphType, MAP_ID

    dev = torch.device(f"cuda:{rank}" if device == "cuda" else "cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = init_group(dev, url, world, rank)
    A = AGENTS_PER_RANK * world

    ds = read_g2o_file(os.path.join(data, "tinyGrid3D.g2o"))
    ms = ds.pose_pose_measurements
    d, n, r = ds.dim, ds.num_poses, 5
    odo, priv, shared, _ = partition_measurements(ms, n, A)
    graphs = []
    for a in range(A):
        g = LocalGraph(a, r, d)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)
    pp = build_parallel_problem(graphs)
    X = lifted.pad_rank(lifted.from_pose_array(
        chordal_initialization(ms, device=dev), device=dev), r)
    Xall = pack_states(pp, [
        RAState(rot=X.rot[s:e], sph=X.sph[:0], trn=X.trn[s:e])
        for s, e in (robot_slice(n, A, a) for a in range(A))], dev)

    rnd = ParallelRound(pp, ROUND_CFG, device=dev, group=group)
    lo, hi = rnd.agents
    central = LocalGraph(0, r, d)
    central.set_measurements(ms)
    P = central.problem_data(device=dev)
    rows = torch.cat([a * pp.n_max + torch.arange(g.n)
                      for a, g in enumerate(graphs)]).to(dev)

    def central_cost(Xs):
        return float(prob.cost(P, RAState(
            rot=Xs.rot.reshape(-1, r, d)[rows], sph=X.sph[:0],
            trn=Xs.trn.reshape(-1, r)[rows])))

    Xb = RAState(*(x[lo:hi] for x in Xall))
    costs = [central_cost(Xall)]
    for _ in range(4):
        Xb, gnorms = rnd(Xb)
        costs.append(central_cost(rnd.gather_states(Xb)))
    gn = rnd.reduce_sq(gnorms)
    if not (np.isfinite(gn) and all(
            c1 <= c0 + 1e-9 * max(1.0, abs(c0))
            for c0, c1 in zip(costs, costs[1:])) and
            costs[-1] < costs[0] - 1e-9):
        raise RuntimeError(f"rank {rank}: central cost not monotone: "
                           f"{costs}")
    _say(rank, f"dryrun_multichip({world}): {A} agents, 4 parallel RBCD "
         f"rounds, monotone central cost {['%.6f' % c for c in costs]}, "
         f"block gradnorm {gn:.4f}")

    # the N-rank round against the one-process round: the Jacobi update is
    # placement-independent, so only the exchange differs
    X1, g1 = ParallelRound(pp, ROUND_CFG, device=dev)(Xall)
    Xn, gn_local = rnd(RAState(*(x[lo:hi] for x in Xall)))
    Xn = rnd.gather_states(Xn)
    for name, a, b in zip(("rot", "sph", "trn"), Xn, X1):
        err = float((a - b).abs().max()) if a.numel() else 0.0
        scale = max(float(b.abs().max()) if b.numel() else 0.0, 1e-300)
        if err > ROUND_TOL * scale:
            raise RuntimeError(f"rank {rank}: the {world}-rank round "
                               f"differs from the one-process round in "
                               f"{name}: {err:.3e}")
    _say(rank, f"dryrun_multichip({world}): round matches the one-process "
         f"round (tol {ROUND_TOL:g} of max|X|)")

    # the edge-sharded certificate: this rank's shards, all_reduced
    from dcora_tpu_torch.core import certify
    from dcora_tpu_torch.parallel.certify import (
        make_sharded_matvec,
        shard_problem_edges,
    )

    Xg = RAState(rot=X1.rot.reshape(-1, r, d)[rows], sph=X.sph[:0],
                 trn=X1.trn.reshape(-1, r)[rows])
    C = certify.dual_certificate_blocks(P, Xg)
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(
        Xg.dims.k), device=dev)
    w = make_sharded_matvec(shard_problem_edges(P, A), C, Xg.dims, group)(
        v, torch.zeros((), dtype=v.dtype, device=dev))
    want = lifted.to_flat(certify.apply_S(
        P, C, lifted.from_flat(v[None], Xg.dims)))[0]
    err = float((w - want).abs().max()) / float(want.abs().max())
    if err > ROUND_TOL:
        raise RuntimeError(f"rank {rank}: the sharded S matvec differs from "
                           f"apply_S: {err:.3e}")
    _say(rank, f"dryrun_multichip({world}): S matvec over {A} edge shards "
         f"on {world} ranks equals apply_S (rel {err:.1e})")

    # the tiled path: every agent's tile products in one launch each
    tile_dtype = torch.float32 if dev.type == "cuda" else torch.float64
    rnd_t = ParallelRound(pp, ROUND_CFG, backend="tiled",
                          tile_dtype=tile_dtype, device=dev, group=group)
    _, g_t = rnd_t(RAState(*(x[lo:hi] for x in Xall)))
    gt = rnd_t.reduce_sq(g_t)
    if not np.isfinite(gt):
        raise RuntimeError(f"rank {rank}: tiled round not finite")
    _say(rank, f"dryrun_multichip({world}): tiled-backend round OK "
         f"({str(tile_dtype).split('.')[-1]} tiles), block gradnorm "
         f"{gt:.4f}")

    # the RA path on a landmark-free set: one robot per agent
    pyfg = os.path.join(data, f"ra_dryrun_{A}.pyfg")
    ra = read_pyfg_file(pyfg)
    gm = get_global_measurements(ra)
    robot_meas = get_robot_measurements(ra)
    ridx = robot_global_indices(ra)
    active = [rid for rid in sorted(ra.robot_IDs) if rid != MAP_ID]
    ra_graphs = []
    for rid in active:
        g = LocalGraph(rid, ra.dim, ra.dim, GraphType.RangeAidedSLAMGraph)
        g.set_measurements(robot_meas[rid].relative_measurements)
        ra_graphs.append(g)
    pp_ra = build_parallel_problem(ra_graphs)
    if pp_ra.fix_sph_src.numel() == 0:
        raise RuntimeError("the RA set has no cross-robot sphere separators")
    X0 = odometry_init_global(ra, gm).to(dev)
    Xra = pack_states(pp_ra, [_slice_agent_state(X0, ridx[rid])
                              for rid in active], dev)
    rnd_ra = ParallelRound(pp_ra, ROUND_CFG, device=dev, group=group)
    _, g_ra = rnd_ra(RAState(*(x[lo:hi] for x in Xra)))
    gra = rnd_ra.reduce_sq(g_ra)
    if not np.isfinite(gra):
        raise RuntimeError(f"rank {rank}: RA round not finite")
    _say(rank, f"dryrun_multichip({world}): RA-SLAM round OK "
         f"(l={sum(g.l for g in ra_graphs)} spheres), block gradnorm "
         f"{gra:.4f}")
    import torch.distributed as dist

    dist.destroy_process_group()


def dryrun(world: int, device: str = "cuda",
           timeout_s: float = TIMEOUT_S) -> int:
    """Run the dry run in `world` processes; returns 0 when every rank
    passed."""
    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards, have "
                           f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as data:
        datasets.ensure_test_datasets(data)
        datasets.generate_ra_slam_pyfg(
            os.path.join(data, f"ra_dryrun_{AGENTS_PER_RANK * world}.pyfg"),
            num_robots=AGENTS_PER_RANK * world, poses_per_robot=4,
            num_landmarks=0, range_prob=0.6, rot_noise=0.01,
            trans_noise=0.01, range_noise=0.01)
        url = f"tcp://localhost:{_free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "dcora_tpu_torch.tools.dryrun_multichip",
             str(world), "--device", dev.type, "--worker", str(rank),
             "--url", url, "--data", data], cwd=ROOT)
            for rank in range(world)]
        codes = []
        try:
            for p in procs:
                codes.append(p.wait(timeout=timeout_s))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(codes) or len(codes) < world:
        print(f"dryrun_multichip({world}): FAILED (exit codes {codes})",
              flush=True)
        return 1
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("world", type=int, help="number of processes (ranks)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--url", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--data", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        torch.set_num_threads(1)
        worker(args.worker, args.world, args.url, args.device, args.data)
        return 0
    return dryrun(args.world, args.device)


if __name__ == "__main__":
    sys.exit(main())
