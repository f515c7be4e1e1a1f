"""Scaling-mode DCORA: synchronous-parallel RBCD for RA-SLAM.

Counterpart of ``dcora_tpu.drivers.parallel_raslam``: the per-robot RA
blocks (lifted poses, unit spheres, landmarks) of a PyFG set all update in
every round against their neighbours' public states of the round before;
the reference's three-dict public-state exchange
(MultiRobotExample_RASLAM.cpp:303-337) is one gathered buffer per agent
(``dcora_tpu_torch.parallel.rbcd``).  The same odometry init and agent
slicing as the greedy driver (``multi_robot_raslam``).

Kept as the JAX driver has it: the map agent is not one of the agents, so
on a set with landmarks (which the map agent owns) the build raises the
JAX package's ``KeyError`` -- the parallel RA mode runs on sets where the
robots range to each other.

Usage: python -m dcora_tpu_torch.drivers.parallel_raslam data.pyfg
       [--device cuda|cpu] [--backend auto|edge|tiled]
       [--config FILE] [--set KEY=VALUE ...]
       [--dist-url tcp://localhost:PORT --world-size W --dist-rank R]
"""

from __future__ import annotations

import argparse
import logging
import time

import torch

from dcora_tpu_torch.config import DcoraConfig, resolve
from dcora_tpu_torch.core import lifted, problem as prob
from dcora_tpu_torch.core.device import resolve_device
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.rtr import riemannian_gradient
from dcora_tpu_torch.drivers.multi_robot_raslam import (
    _scatter_agent_state,
    _slice_agent_state,
)
from dcora_tpu_torch.drivers.parallel_pgo import ROUND_CFG
from dcora_tpu_torch.drivers.single_robot_raslam import odometry_init_global
from dcora_tpu_torch.io import read_pyfg_file
from dcora_tpu_torch.io.remap import (
    get_global_measurements,
    get_robot_measurements,
    robot_global_indices,
)
from dcora_tpu_torch.parallel.rbcd import (
    ParallelResult,
    ParallelRound,
    add_group_args,
    build_parallel_problem,
    init_group,
    pack_states,
    resolve_backend,
    run_rounds,
    unpack_states,
)
from dcora_tpu_torch.types import GraphType, MAP_ID


def run(pyfg_path: str, r: int = 0, max_rounds: int = 1000,
        rgrad_norm_tol: float = 0.1, check_every: int = 10,
        verbose: bool = False, backend: str = "auto", tile_dtype=None,
        device="cuda", group=None) -> ParallelResult:
    t0 = time.time()
    dev = resolve_device(device)
    backend, tile_dtype = resolve_backend(backend, tile_dtype, dev)
    ds = read_pyfg_file(pyfg_path)
    gm = get_global_measurements(ds)
    robot_meas = get_robot_measurements(ds)
    ridx = robot_global_indices(ds)
    d = ds.dim
    r = r or d  # the reference staircase starts at r_min = d
    gt = gm.ground_truth_init
    n, l, b = gt.n, gt.l, gt.b  # noqa: E741

    # the map agent owns nothing and is rejected by the reference driver
    # (MultiRobotExample_RASLAM.cpp:37-42)
    active = [rid for rid in sorted(ds.robot_IDs) if rid != MAP_ID]
    graphs = []
    for rid in active:
        g = LocalGraph(rid, r, d, GraphType.RangeAidedSLAMGraph)
        g.set_measurements(robot_meas[rid].relative_measurements)
        graphs.append(g)
    X0 = odometry_init_global(ds, gm)
    if X0.r < r:
        X0 = lifted.pad_rank(X0, r)
    X0 = X0.to(dev)
    states = [_slice_agent_state(X0, ridx[rid]) for rid in active]

    pp = build_parallel_problem(graphs)
    rnd = ParallelRound(pp, ROUND_CFG, backend=backend,
                        tile_dtype=tile_dtype, device=dev, group=group)
    lo, hi = rnd.agents
    Xb = RAState(*(x[lo:hi] for x in pack_states(pp, states, dev)))

    P = G0 = None
    if rnd.world == 1:
        central = LocalGraph(0, r, d, GraphType.RangeAidedSLAMGraph)
        central.set_measurements(gm.relative_measurements)
        P = central.problem_data(device=dev)
        G0 = lifted.zeros(central.dims, r, device=dev)

    def global_state(Xs) -> RAState:
        kw = dict(dtype=torch.float64, device=dev)
        Xg = RAState(rot=torch.zeros((n, r, d), **kw),
                     sph=torch.zeros((l, r), **kw),
                     trn=torch.zeros((n + b, r), **kw))
        for a, part in enumerate(unpack_states(pp, Xs)):
            _scatter_agent_state(Xg, part, ridx[active[a]], n)
        return Xg

    def evaluate(Xs):
        Xg = global_state(Xs)
        return (2.0 * float(prob.cost(P, Xg)),
                float(riemannian_gradient(P, Xg, G0).norm()))

    Xb, rounds, trace, gradnorm, rounds_s = run_rounds(
        rnd, Xb, max_rounds, check_every, rgrad_norm_tol, evaluate, verbose)
    X_stack = rnd.gather_states(Xb)
    Xg, cost = None, float("nan")
    if rnd.world == 1:
        Xg = global_state(X_stack)
        cost = 2.0 * float(prob.cost(P, Xg))
    elapsed = time.time() - t0
    print(f"parallel-DCORA: agents={len(active)} rounds={rounds} "
          f"cost={cost:.6f} gradnorm={gradnorm:.4f} elapsed={elapsed:.1f}s "
          f"({rounds * (n + l + b) / max(elapsed, 1e-9):.0f} "
          "state-updates/s)")
    return ParallelResult(X=Xg, X_stack=X_stack, cost=cost,
                          gradnorm=gradnorm, rounds=rounds, trace=trace,
                          rounds_s=rounds_s, elapsed_s=elapsed,
                          columns=pp.scalar_columns())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pyfg")
    ap.add_argument("--rank", type=int, default=0,
                    help="relaxation rank (default: d)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="default: rbcd.num_iters, 1000")
    ap.add_argument("--tol", type=float, default=None,
                    help="default: rbcd.rgrad_norm_tol, 0.1")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "edge", "tiled"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--verbose", action="store_true")
    add_group_args(ap)
    DcoraConfig.add_cli(ap)
    args = ap.parse_args(argv)
    cfg = DcoraConfig.from_cli(args)
    logging.getLogger(__name__).info("config:\n%s", cfg.dump())
    dev = resolve_device(args.device)
    group = init_group(dev, args.dist_url, args.world_size, args.dist_rank)
    return run(args.pyfg, r=args.rank,
               max_rounds=resolve(args.rounds, cfg.rbcd.num_iters),
               rgrad_norm_tol=resolve(args.tol, cfg.rbcd.rgrad_norm_tol),
               verbose=args.verbose, backend=args.backend, device=dev,
               group=group)


if __name__ == "__main__":
    main()
