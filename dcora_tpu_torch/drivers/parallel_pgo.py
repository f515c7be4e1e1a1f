"""Scaling-mode DC2-PGO: synchronous-parallel RBCD of every agent at once.

Counterpart of ``dcora_tpu.drivers.parallel_pgo``: the same contiguous
partition as the greedy driver (``multi_robot_pgo.partition_measurements``),
the Chordal init, then rounds in which every agent's block updates against
its neighbours' public states of the round before
(``dcora_tpu_torch.parallel.rbcd``).  All agents live on one device, along
an agent axis; with a torch.distributed group each rank owns A/W of them
and the separator exchange is an all_gather.  ``--backend auto`` runs the
tiled path with float32 tiles on cuda (every tile product of every agent in
one launch of the strip kernel) and the edge path at float64 on the CPU.

``run`` is ``prepare`` (the partition, the agents' graphs, the start, the
batched problem, the ParallelRound and the central check) then
``rbcd.run_rounds`` and the result; a caller that times the rounds alone
(the benchmark) calls the two itself.

Usage: python -m dcora_tpu_torch.drivers.parallel_pgo NUM_AGENTS file.g2o
       [--device cuda|cpu] [--backend auto|edge|tiled]
       [--config FILE] [--set KEY=VALUE ...]
       [--dist-url tcp://localhost:PORT --world-size W --dist-rank R]
(or one process per rank under torchrun).
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from dcora_tpu_torch.config import DcoraConfig, resolve
from dcora_tpu_torch.core import lifted, problem as prob
from dcora_tpu_torch.core.device import resolve_device
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import chordal_initialization
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.rtr import RTRConfig, riemannian_gradient
from dcora_tpu_torch.drivers.multi_robot_pgo import (
    partition_measurements,
    robot_slice,
)
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.parallel.rbcd import (
    ParallelResult,
    ParallelRound,
    add_group_args,
    build_parallel_problem,
    init_group,
    pack_states,
    resolve_backend,
    run_rounds,
)

# the block update of every round (dcora_tpu/drivers/parallel_pgo.py:132)
ROUND_CFG = RTRConfig(gradnorm_tol=1e-2, max_inner=50,
                      single_accepted_step=True)


class ParallelSetup(NamedTuple):
    """What prepare() returns: the round, this rank's packed start, the
    central check and the map from a stack to the global state."""

    rnd: ParallelRound
    Xb: RAState               # this rank's agents' [A/W, ...] start
    # Xs -> (2 f, gradnorm) over every pose, at float64 (one process only)
    evaluate: Callable[[RAState], Tuple[float, float]]
    # every agent's stack -> the global state, agent after agent
    global_state: Callable[[RAState], RAState]


def prepare(num_agents: int, measurements, n: int, d: int, r: int = 5,
            backend: str = "auto", tile_dtype=None, device="cuda",
            group=None, start: Optional[RAState] = None) -> ParallelSetup:
    """The set-up of a parallel run over the n poses' pose-pose
    `measurements`: the contiguous partition into num_agents
    (multi_robot_pgo.robot_slice), each agent's LocalGraph, the start
    packed per agent, the batched problem, the ParallelRound with the
    block update ROUND_CFG, and, with one process, the central problem of
    the check.  `start` is a global lifted state at rank r (every pose,
    float64); None takes the driver's own chordal init."""
    dev = resolve_device(device)
    backend, tile_dtype = resolve_backend(backend, tile_dtype, dev)
    odo, priv, shared, _ = partition_measurements(measurements, n,
                                                  num_agents)
    graphs = []
    for a in range(num_agents):
        g = LocalGraph(a, r, d)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)
    if start is None:
        T = chordal_initialization(measurements, device=dev)
        start = lifted.pad_rank(lifted.from_pose_array(T, device=dev), r)
    states = []
    for a in range(num_agents):
        s, e = robot_slice(n, num_agents, a)
        states.append(RAState(rot=start.rot[s:e], sph=start.sph[:0],
                              trn=start.trn[s:e]))

    pp = build_parallel_problem(graphs)
    rnd = ParallelRound(pp, ROUND_CFG, backend=backend,
                        tile_dtype=tile_dtype, device=dev, group=group)
    lo, hi = rnd.agents
    Xb = RAState(*(x[lo:hi] for x in pack_states(pp, states, dev)))

    # the global state: each agent's real poses, agent after agent
    rows = torch.cat([a * pp.n_max + torch.arange(g.n)
                      for a, g in enumerate(graphs)]).to(dev)

    def global_state(Xs):
        return RAState(rot=Xs.rot.reshape(-1, r, d)[rows],
                       sph=Xs.sph.reshape(-1, r),
                       trn=Xs.trn.reshape(-1, r)[rows])

    P = G0 = None
    if rnd.world == 1:
        central = LocalGraph(0, r, d)
        central.set_measurements(measurements)
        P = central.problem_data(device=dev)
        G0 = lifted.zeros(central.dims, r, device=dev)

    def evaluate(Xs):
        Xg = global_state(Xs)
        return (2.0 * float(prob.cost(P, Xg)),
                float(riemannian_gradient(P, Xg, G0).norm()))

    return ParallelSetup(rnd, Xb, evaluate, global_state)


def run(num_agents: int, g2o_path: str, r: int = 5, max_rounds: int = 1000,
        rgrad_norm_tol: float = 0.1, check_every: int = 10,
        verbose: bool = False, backend: str = "auto", tile_dtype=None,
        device="cuda", group=None) -> ParallelResult:
    """The driver: read the g2o file, prepare() from the chordal init,
    run_rounds until the central gradnorm falls below rgrad_norm_tol or
    max_rounds, then the global state and its 2 f."""
    t0 = time.time()
    ds = read_g2o_file(g2o_path)
    n = ds.num_poses
    setup = prepare(num_agents, ds.pose_pose_measurements, n, ds.dim, r,
                    backend, tile_dtype, device, group)
    rnd = setup.rnd
    Xb, rounds, trace, gradnorm, rounds_s = run_rounds(
        rnd, setup.Xb, max_rounds, check_every, rgrad_norm_tol,
        setup.evaluate, verbose)
    X_stack = rnd.gather_states(Xb)
    Xg, cost = None, float("nan")
    if rnd.world == 1:
        Xg = setup.global_state(X_stack)
        cost = setup.evaluate(X_stack)[0]
    elapsed = time.time() - t0
    print(f"parallel-RBCD: agents={num_agents} rounds={rounds} "
          f"cost={cost:.6f} gradnorm={gradnorm:.4f} elapsed={elapsed:.1f}s "
          f"({rounds * n / max(elapsed, 1e-9):.0f} pose-updates/s)")
    return ParallelResult(X=Xg, X_stack=X_stack, cost=cost,
                          gradnorm=gradnorm, rounds=rounds, trace=trace,
                          rounds_s=rounds_s, elapsed_s=elapsed,
                          columns=rnd.pp.scalar_columns())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("num_agents", type=int)
    ap.add_argument("g2o")
    ap.add_argument("--rank", type=int, default=None,
                    help="default: staircase.r_min, 5")
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
    return run(args.num_agents, args.g2o,
               r=resolve(args.rank, cfg.staircase.r_min),
               max_rounds=resolve(args.rounds, cfg.rbcd.num_iters),
               rgrad_norm_tol=resolve(args.tol, cfg.rbcd.rgrad_norm_tol),
               verbose=args.verbose, backend=args.backend, device=dev,
               group=group)


if __name__ == "__main__":
    main()
