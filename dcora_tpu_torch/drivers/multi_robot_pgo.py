"""DC2-PGO: multi-robot distributed PGO with the Riemannian staircase.

Counterpart of ``dcora_tpu.drivers.multi_robot_pgo`` (mirrors
examples/MultiRobotExample.cpp): partition a g2o pose graph into contiguous
per-robot blocks, run RBCD(++) rounds with greedy block selection and
simulated public-state exchange, certify centrally, and escape saddles
across staircase ranks; with a non-L2 robust cost, the distributed GNC
pipeline.  Every tensor lives on `device` (the card unless the caller asks
for the CPU).

Two behaviours of the JAX driver are kept as they are, so that both engines
give the same results: ``escape_saddle`` is called without the
preconditioner M, and ``--init random`` draws from a ``torch.Generator``
(seeded with 0) where the JAX driver draws from ``jax.random``.

Usage: python -m dcora_tpu_torch.drivers.multi_robot_pgo NUM_ROBOTS file.g2o
       [--device cuda|cpu] [--init random|odometry|chordal] [--robust]
       [--config FILE] [--set KEY=VALUE ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dcora_tpu_torch.agent import Agent
from dcora_tpu_torch.config import DcoraConfig, resolve
from dcora_tpu_torch.core import lifted, manifold, problem as prob
from dcora_tpu_torch.core.certify import escape_saddle, fast_verification
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import (
    chordal_initialization,
    odometry_initialization,
)
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.rtr import riemannian_gradient
from dcora_tpu_torch.core.segment import SegmentMap, build_map, segment_sum
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.measurements import RelativePosePoseMeasurement
from dcora_tpu_torch.solvers import resolve_device
from dcora_tpu_torch.types import (
    AgentParameters,
    InitializationMethod,
    ProblemDims,
    RobustCostParameters,
    RobustCostType,
)
from dcora_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

logger = logging.getLogger(__name__)


def central_eval(P, G0, X, pose_blocks: SegmentMap, num_robots):
    """cost, Riemannian gradnorm and per-robot block gradient norms, read
    back in one copy (reference loop: MultiRobotExample.cpp:263-305).
    pose_blocks maps every pose onto its robot (segment.build_map)."""
    RGrad = riemannian_gradient(P, X, G0)
    sq = (RGrad.rot ** 2).sum(dim=(1, 2)) + (RGrad.trn ** 2).sum(dim=1)
    per_block = segment_sum(sq, pose_blocks, num_robots)
    out = torch.cat([torch.stack([prob.cost(P, X, G0), RGrad.norm()]),
                     torch.sqrt(per_block)]).tolist()
    return out[0], out[1], out[2:]


def partition_measurements(measurements, n: int, num_robots: int):
    """Contiguous-chunk partition (reference: MultiRobotExample.cpp:72-118).

    Returns (odometry, private_lcs, shared_lcs) per robot plus the
    global->local pose map.
    """
    npr = n // num_robots
    assert npr > 0, "more robots than poses"

    def robot_of(idx):
        rid = min(idx // npr, num_robots - 1)
        return rid, idx - rid * npr

    odometry = [[] for _ in range(num_robots)]
    private = [[] for _ in range(num_robots)]
    shared = [[] for _ in range(num_robots)]
    for m_in in measurements:
        r1, i1 = robot_of(m_in.p1)
        r2, i2 = robot_of(m_in.p2)
        m = RelativePosePoseMeasurement(
            r1, i1, r2, i2, m_in.R, m_in.t, m_in.kappa, m_in.tau,
            weight=m_in.weight, fixedWeight=m_in.fixedWeight,
        )
        if r1 == r2:
            if i1 + 1 == i2:
                odometry[r1].append(m)
            else:
                private[r1].append(m)
        else:
            shared[r1].append(m)
            shared[r2].append(m)
    return odometry, private, shared, robot_of


def _collect_weights(agents, n: int, num_robots: int) -> dict:
    """Snapshot the agents' GNC weights as {(p1_global, p2_global): w}: the
    one weight state carried across ranks (fresh agents and the central
    problem are re-weighted from it by _apply_weights)."""
    npr = n // num_robots
    out = {}
    for a in agents:
        for m in a.graph.active_loop_closures():
            if not m.fixedWeight:
                out[(m.r1 * npr + m.p1, m.r2 * npr + m.p2)] = float(m.weight)
    return out


def _apply_weights(measurements, weight_state: dict, n: int,
                   num_robots: int, local: bool) -> None:
    """Write the weight state onto a measurement list; `local` selects
    (robot, index) keys mapped through the contiguous partition."""
    if not weight_state:
        return
    npr = n // num_robots
    for m in measurements:
        key = ((m.r1 * npr + m.p1, m.r2 * npr + m.p2) if local
               else (m.p1, m.p2))
        w = weight_state.get(key)
        if w is not None and not m.fixedWeight:
            m.weight = w


def robot_slice(n: int, num_robots: int, robot: int):
    npr = n // num_robots
    start = robot * npr
    end = n if robot == num_robots - 1 else (robot + 1) * npr
    return start, end


@dataclasses.dataclass
class MultiRobotResult:
    X: RAState
    certified: bool
    final_rank: int
    total_iters: int
    cost_trace: List[float]
    gradnorm_trace: List[float]
    trajectories: Dict[int, np.ndarray]
    elapsed_s: float
    # final GNC weights of non-fixed edges, keyed by global (p1, p2)
    weights: Optional[Dict[tuple, float]] = None
    # certificate diagnostics: the last min-eig estimate and the
    # gradnorm-dependent slack it was judged against (see adaptive stop)
    final_theta: Optional[float] = None
    cert_slack: Optional[float] = None
    # host seconds of the RBCD rounds (one cost_trace entry each)
    rbcd_s: float = 0.0


def run(num_robots: int, g2o_path: str, acceleration: bool = True,
        num_iters: int = 1000, r_min: int = 5, r_max: int = 100,
        rgrad_norm_tol: float = 0.1, min_eig_num_tol: float = 1e-3,
        init_method: InitializationMethod = InitializationMethod.Random,
        rbcd_only: bool = False, verbose: bool = False,
        log_directory: str = "",
        checkpoint_path: str = "",
        robust_cost_params: Optional[RobustCostParameters] = None,
        robust_weight_updates: int = 10,  # reference default (Agent.h:119)
        robust_inner_iters: int = 30,  # reference default (Agent.h:121)
        robust_update_gradnorm_gate: Optional[float] = None,
        adaptive_stop: bool = True,
        cert_slack_c: float = 1.0, device="cuda",
        lifting_matrix: Optional[Callable[[int], np.ndarray]] = None,
        generator: Optional[torch.Generator] = None) -> MultiRobotResult:
    """The JAX driver's run on `device`; see dcora_tpu.drivers.
    multi_robot_pgo.run for the distributed GNC pipeline (weight updates
    gated on convergence, adaptive mu init, budget extension, terminal
    repair and re-anneal) and the adaptive certificate stop, which this
    follows step for step.  `lifting_matrix` (rank r -> agent 0's [r, d]
    lifting matrix at that rank) and `generator` (the Random init) replace
    the JAX package's jax.random draws."""
    t_start = time.time()
    dev = resolve_device(device)
    ds = read_g2o_file(g2o_path)
    measurements = ds.pose_pose_measurements
    d, n = ds.dim, ds.num_poses
    robot_ids = frozenset(range(num_robots))

    odometry, private, shared, _ = partition_measurements(
        measurements, n, num_robots
    )

    # initial estimate at rank r_min (reference: MultiRobotExample.cpp:141-169)
    if init_method == InitializationMethod.Odometry:
        odo_central = [m for m in measurements if m.p1 + 1 == m.p2]
        T = odometry_initialization(odo_central)
        Xcurr = lifted.pad_rank(lifted.from_pose_array(T, device=dev), r_min)
    elif init_method == InitializationMethod.Chordal:
        T = chordal_initialization(measurements, device=dev)
        Xcurr = lifted.pad_rank(lifted.from_pose_array(T, device=dev), r_min)
    else:
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        Xcurr = manifold.random_state(ProblemDims(d, n), r_min,
                                      gen).to(dev)

    total_iter = 0
    cost_trace: List[float] = []
    grad_trace: List[float] = []
    certified = False
    r = r_min
    trajectories: Dict[int, np.ndarray] = {}
    tol_eff = rgrad_norm_tol
    tightenings = 0
    final_theta: Optional[float] = None
    cert_slack: Optional[float] = None
    rbcd_s = 0.0

    # robot id of every pose (for greedy block-gradient norms)
    pose_blocks = build_map([[min(i // max(n // num_robots, 1),
                                  num_robots - 1) for i in range(n)]], dev)

    if checkpoint_path and os.path.exists(checkpoint_path):
        Xcurr, r, _, _ = load_checkpoint(checkpoint_path, device=dev)
        logger.info("resuming DC2-PGO from checkpoint at rank %d", r)

    # explicit GNC weight state carried across ranks, and the distributed
    # GNC coordination state (see the robust block below)
    weight_state: Dict[tuple, float] = {}
    update_gate = (robust_update_gradnorm_gate
                   if robust_update_gradnorm_gate is not None
                   else 10.0 * rgrad_norm_tol)
    mu_initialized = False
    extra_updates = 0
    repair_passes = 0
    max_repair_passes = 8
    reannealed = False
    robust = (robust_cost_params is not None
              and robust_cost_params.costType != RobustCostType.L2)

    while True:
        for robot in range(num_robots):
            _apply_weights(private[robot] + shared[robot], weight_state,
                           n, num_robots, local=True)
        _apply_weights(measurements, weight_state, n, num_robots,
                       local=False)
        central = LocalGraph(0, r, d)
        central.set_measurements(measurements)
        P = central.problem_data(device=dev)
        G0 = lifted.zeros(central.dims, r, device=dev)

        # fresh agents at this rank (reference: MultiRobotExample.cpp:184-217)
        agents: List[Agent] = []
        for robot in range(num_robots):
            options = AgentParameters(
                d=d, r=r, robotIDs=robot_ids, acceleration=acceleration,
                verbose=verbose, logData=bool(log_directory),
                logDirectory=log_directory,
            )
            if robust:
                options.robustCostParams = robust_cost_params
                options.robustOptNumWeightUpdates = robust_weight_updates
                options.robustOptInnerIters = robust_inner_iters
            agent = Agent(robot, options, device=dev,
                          lifting_matrix=(lifting_matrix(r)
                                          if lifting_matrix else None))
            if robot > 0:
                agent.set_lifting_matrix(agents[0].get_lifting_matrix())
            agent.set_measurements(
                odometry[robot] + private[robot] + shared[robot]
            )
            agent.initialize()
            agents.append(agent)

        for robot in range(num_robots):
            s, e = robot_slice(n, num_robots, robot)
            agents[robot].set_X(RAState(rot=Xcurr.rot[s:e],
                                        sph=Xcurr.sph[:0],
                                        trn=Xcurr.trn[s:e]))

        def refresh_neighbors(a):
            for b_ in agents:
                if b_.id == a.id:
                    continue
                dicts = b_.get_shared_state_dicts()
                if dicts is not None:
                    a.update_neighbor_states(b_.id, dicts[0])

        def reweight_central():
            weight_state.update(_collect_weights(agents, n, num_robots))
            _apply_weights(measurements, weight_state, n, num_robots,
                           local=False)
            central.set_measurements(measurements)
            return central.problem_data(device=dev)

        Xopt = Xcurr
        selected = 0
        gradnorm = float("inf")
        t_rbcd = time.perf_counter()
        for it in range(num_iters):
            sel = agents[selected]
            for a in agents:
                if a.id != selected:
                    a.iterate(False)
            # simulated communication (reference: :236-258)
            for a in agents:
                if a.id == selected:
                    continue
                dicts = a.get_shared_state_dicts()
                if dicts is None:
                    continue
                sel.set_neighbor_status(a.get_status())
                sel.update_neighbor_states(a.id, dicts[0])
                if acceleration:
                    aux = a.get_shared_state_dicts(aux=True)
                    sel.set_neighbor_status(a.get_status())
                    sel.update_neighbor_states(a.id, aux[0], aux=True)
            sel.iterate(True)

            # cost stagnation over one full selection sweep
            stagnated = (
                len(cost_trace) > num_robots
                and abs(cost_trace[-1] - cost_trace[-1 - num_robots])
                <= 1e-5 * max(1.0, abs(cost_trace[-1]))
            )

            if robust:
                # status gossip (in the reference: the ROS status topic)
                for a in agents:
                    for b_ in agents:
                        if b_.id != a.id:
                            a.set_neighbor_status(b_.get_status())
                # weight updates fire once the current weighted problem is
                # near-converged, stagnated, or past a hard cap
                hard_cap = 5 * robust_inner_iters
                gate_ok = (gradnorm < update_gate) or stagnated or any(
                    a.robust_opt_inner_iter >= hard_cap for a in agents)
                any_update = False
                if gate_ok:
                    ready = [a for a in agents
                             if a.should_update_measurement_weights()]
                    if ready and not mu_initialized:
                        # adaptive global mu init from the team max
                        # residual (DCORA_solver.cpp:349-357)
                        for a in agents:
                            refresh_neighbors(a)
                        rs = [a.max_measurement_residual() for a in agents]
                        rs = [x for x in rs if x is not None]
                        barc_sq = robust_cost_params.GNCBarc ** 2
                        if rs and 2 * max(rs) ** 2 > barc_sq:
                            mu0 = barc_sq / (2 * max(rs) ** 2 - barc_sq)
                            for a in agents:
                                a.set_gnc_mu(mu0)
                            logger.info(
                                "adaptive GNC mu init: max residual %.3f"
                                " -> mu %.3e", max(rs), mu0)
                        mu_initialized = True
                    for a in ready:
                        refresh_neighbors(a)
                        a.update_measurement_weights()
                        any_update = True
                if any_update:
                    P = reweight_central()
                # budget extension while undecided edges remain
                # (DCORA_solver.cpp:366-405)
                if any_update and all(
                        a.weight_update_count >=
                        a.params.robustOptNumWeightUpdates
                        for a in agents):
                    undecided = sum(a.num_undecided_measurements()
                                    for a in agents)
                    if undecided > 0 and \
                            extra_updates < 2 * robust_weight_updates:
                        for a in agents:
                            a.params.robustOptNumWeightUpdates += 1
                        extra_updates += 1
                        logger.info(
                            "GNC: %d undecided edges at budget; "
                            "extending (+%d)", undecided, extra_updates)

            # assemble central estimate
            Xopt = RAState(
                rot=torch.cat([a.get_X().rot for a in agents]),
                sph=Xcurr.sph[:0],
                trn=torch.cat([a.get_X().trn for a in agents]),
            )
            cost_h, gradnorm, block_norms = central_eval(
                P, G0, Xopt, pose_blocks, num_robots)
            cost = 2.0 * cost_h
            cost_trace.append(cost)
            grad_trace.append(gradnorm)
            if verbose or it % 50 == 0:
                print(
                    f"Iter = {total_iter} | robot = {selected} | "
                    f"cost = {cost:.6f} | gradnorm = {gradnorm:.4f}"
                )
            robust_done = (not robust) or all(
                a.weight_update_count >= a.params.robustOptNumWeightUpdates
                for a in agents
            )
            # terminal weight repair at the settled estimate, then one
            # re-annealing pass (see the JAX driver for the measurements)
            if (robust and robust_done
                    and repair_passes < max_repair_passes
                    and (gradnorm < tol_eff
                         or (stagnated and gradnorm < update_gate))):
                repair_passes += 1
                changed = 0
                for a in agents:
                    refresh_neighbors(a)
                    changed += a.reclassify_measurement_weights()
                if changed == 0 and not reannealed:
                    reannealed = True
                    for a in agents:
                        a.set_gnc_mu(0.2, reset_schedule=True)
                        a.params.robustOptNumWeightUpdates += 20
                        changed += a.reclassify_measurement_weights()
                    logger.info(
                        "GNC re-anneal: mu reset to 0.2, %d weights "
                        "re-opened, +20 update budget", changed)
                if changed:
                    logger.info(
                        "GNC repair pass %d: %d weights re-judged at "
                        "settled estimate (gradnorm %.3e)",
                        repair_passes, changed, gradnorm)
                    P = reweight_central()
                    total_iter += 1
                    continue
            if gradnorm < tol_eff and robust_done:
                break

            # greedy selection by block gradient norm (reference: :289-305)
            if sel.get_neighbors():
                selected = int(np.argmax(block_norms))
            total_iter += 1
        rbcd_s += time.perf_counter() - t_rbcd

        def finish():
            anchor = agents[0].get_X().pose(0).cpu().numpy()
            for a in agents:
                a.set_global_anchor(anchor)
                trajectories[a.id] = a.get_trajectory_in_global_frame()
                a.reset()

        if rbcd_only:
            finish()
            Xcurr = Xopt
            break

        # certification (reference: :310-330)
        is_psd, theta, v = fast_verification(
            P, Xopt, min_eig_num_tol,
            num_lanczos=min(64, central.dims.k - 1),
        )
        final_theta = float(theta)
        cert_slack = cert_slack_c * gradnorm
        if is_psd and adaptive_stop and tightenings < 4 \
                and gradnorm > 10.0 * min_eig_num_tol:
            # PSD above the gradient-noise floor: drive the RBCD gradient
            # down to ~10*eta before trusting the certificate
            tol_eff = max(gradnorm / 10.0, 10.0 * min_eig_num_tol)
            tightenings += 1
            logger.info(
                "rank %d PSD at gradnorm %.3e > 10*eta=%.1e: tightening "
                "RBCD tol to %.1e before certifying", r, gradnorm,
                10.0 * min_eig_num_tol, tol_eff,
            )
            Xcurr = Xopt
            continue
        if not is_psd and adaptive_stop and tightenings < 4 \
                and gradnorm < tol_eff and theta > -cert_slack:
            # inconclusive: |theta| within the O(gradnorm) certificate
            # error; tighten the RBCD stop and continue at this rank
            tol_eff = gradnorm / 10.0
            tightenings += 1
            logger.info(
                "rank %d certificate inconclusive (theta=%.3e, slack=%.3e)"
                ": tightening RBCD tol to %.1e", r, theta, cert_slack,
                tol_eff,
            )
            Xcurr = Xopt
            continue
        if is_psd:
            certified = True
            finish()
            Xcurr = Xopt
            break
        logger.info("saddle at rank %d, theta=%.3e", r, theta)
        if r >= r_max:
            logger.warning("rank cap r_max=%d reached uncertified", r_max)
            Xcurr = Xopt
            break
        # second-order alpha + the reference's escape tolerances
        # (MultiRobotExample.cpp:354-363); without M, as the JAX driver
        ok, Xnext = escape_saddle(
            P, Xopt, theta, v, r + 1,
            gradient_tolerance=1e-6,
            preconditioned_gradient_tolerance=1e-6,
            is_second_order=True,
        )
        if not ok:
            Xcurr = Xopt
            break
        Xcurr = Xnext
        r += 1
        if checkpoint_path:
            save_checkpoint(checkpoint_path, Xcurr, r)

    weights = {
        (m.p1, m.p2): float(m.weight)
        for m in measurements if not m.fixedWeight
    }
    return MultiRobotResult(
        X=Xcurr, certified=certified, final_rank=r, total_iters=total_iter,
        cost_trace=cost_trace, gradnorm_trace=grad_trace,
        trajectories=trajectories, elapsed_s=time.time() - t_start,
        weights=weights, final_theta=final_theta, cert_slack=cert_slack,
        rbcd_s=rbcd_s,
    )


INIT_METHODS = {"random": InitializationMethod.Random,
                "odometry": InitializationMethod.Odometry,
                "chordal": InitializationMethod.Chordal}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("num_robots", type=int)
    ap.add_argument("g2o")
    ap.add_argument("--no-accel", action="store_true")
    ap.add_argument("--iters", type=int, default=None,
                    help="RBCD rounds (default: rbcd.num_iters, 1000)")
    ap.add_argument("--rmin", type=int, default=None,
                    help="lowest rank (default: staircase.r_min, 5)")
    ap.add_argument("--rmax", type=int, default=None,
                    help="highest rank (default: staircase.r_max, 100)")
    ap.add_argument("--init", default="random", choices=list(INIT_METHODS))
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--robust", action="store_true",
                    help="distributed GNC-TLS robust optimization")
    ap.add_argument("--gnc-barc", type=float, default=None,
                    help="GNC barc (default: robust.GNCBarc, 5.0)")
    ap.add_argument("--weight-updates", type=int, default=None,
                    help="default: rbcd.robust_opt_num_weight_updates, 10")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    DcoraConfig.add_cli(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = DcoraConfig.from_cli(args)
    logger.info("config:\n%s", cfg.dump())
    rcp = None
    if args.robust:
        rcp = cfg.robust
        rcp.costType = RobustCostType.GNC_TLS
        rcp.GNCBarc = resolve(args.gnc_barc, rcp.GNCBarc)
    res = run(
        args.num_robots, args.g2o,
        acceleration=(not args.no_accel) and cfg.rbcd.acceleration,
        num_iters=resolve(args.iters, cfg.rbcd.num_iters),
        r_min=resolve(args.rmin, cfg.staircase.r_min),
        r_max=resolve(args.rmax, cfg.staircase.r_max),
        rgrad_norm_tol=cfg.rbcd.rgrad_norm_tol,
        min_eig_num_tol=cfg.staircase.min_eig_num_tol,
        init_method=INIT_METHODS[args.init], verbose=args.verbose,
        robust_cost_params=rcp,
        robust_weight_updates=resolve(
            args.weight_updates, cfg.rbcd.robust_opt_num_weight_updates),
        robust_inner_iters=cfg.rbcd.robust_opt_inner_iters,
        checkpoint_path=args.checkpoint, device=args.device,
    )
    print(
        f"DC2-PGO: certified={res.certified} rank={res.final_rank} "
        f"iters={res.total_iters} final_cost={res.cost_trace[-1]:.6f} "
        f"elapsed={res.elapsed_s:.1f}s"
    )


if __name__ == "__main__":
    main()
