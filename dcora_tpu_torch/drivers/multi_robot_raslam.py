"""DCORA: multi-robot distributed RA-SLAM with the Riemannian staircase.

Counterpart of ``dcora_tpu.drivers.multi_robot_raslam`` (mirrors
examples/MultiRobotExample_RASLAM.cpp): per-robot RA subproblems from a
PyFG dataset, RBCD(++) with Greedy or Uniform block selection and
three-dict (pose/unit-sphere/landmark) public state exchange, central RA
certification, saddle escape across ranks.  Every tensor lives on `device`
(the card unless the caller asks for the CPU).

Two behaviours of the JAX driver are kept as they are, so that both engines
give the same results: the staircase loop runs ``while r < r_max``, so a
rank that an escape lands on at r_max is never optimized, and
``escape_saddle`` is called without the preconditioner M.  ``--init
random`` draws from a ``torch.Generator`` seeded with ``seed`` where the
JAX driver draws from ``jax.random``.

Usage: python -m dcora_tpu_torch.drivers.multi_robot_raslam data.pyfg
       [--device cuda|cpu] [--config FILE] [--set KEY=VALUE ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dcora_tpu_torch.agent import Agent
from dcora_tpu_torch.config import DcoraConfig, resolve
from dcora_tpu_torch.core import lifted, manifold, problem as prob
from dcora_tpu_torch.core.certify import escape_saddle, fast_verification
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.rtr import riemannian_gradient
from dcora_tpu_torch.drivers.single_robot_raslam import odometry_init_global
from dcora_tpu_torch.io import read_pyfg_file
from dcora_tpu_torch.io.remap import (
    get_global_measurements,
    get_robot_measurements,
    robot_global_indices,
)
from dcora_tpu_torch.solvers import resolve_device
from dcora_tpu_torch.types import (
    AgentParameters,
    BlockSelectionRule,
    GraphType,
    InitializationMethod,
    MAP_ID,
)

logger = logging.getLogger(__name__)


def _slice_agent_state(X: RAState, idx: Dict[str, np.ndarray]) -> RAState:
    """Extract one agent's local block from the global RAState."""
    dev = X.rot.device

    def ix(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    return RAState(
        rot=X.rot[ix(idx["poses"])],
        sph=X.sph[ix(idx["spheres"])],
        trn=torch.cat([X.trn[ix(idx["poses"])],
                       X.trn[ix(X.n + np.asarray(idx["landmarks"],
                                                  dtype=np.int64))]]),
    )


def _scatter_agent_state(X_glob: RAState, X_a: RAState,
                         idx: Dict[str, np.ndarray], n_glob: int):
    """Write one agent's block into the global state, in place."""
    dev = X_glob.rot.device
    poses = torch.as_tensor(np.asarray(idx["poses"], dtype=np.int64),
                            device=dev)
    npose = len(idx["poses"])
    if npose:
        X_glob.rot[poses] = X_a.rot
        X_glob.trn[poses] = X_a.trn[:npose]
    if len(idx["spheres"]):
        X_glob.sph[torch.as_tensor(np.asarray(idx["spheres"], np.int64),
                                   device=dev)] = X_a.sph
    if len(idx["landmarks"]):
        X_glob.trn[torch.as_tensor(
            n_glob + np.asarray(idx["landmarks"], np.int64),
            device=dev)] = X_a.trn[npose:]


@dataclasses.dataclass
class MultiRobotRAResult:
    X: RAState
    certified: bool
    final_rank: int
    total_iters: int
    cost_trace: List[float]
    gradnorm_trace: List[float]
    trajectories: Dict[int, np.ndarray]
    elapsed_s: float
    # certificate diagnostics (see multi_robot_pgo adaptive stop)
    final_theta: Optional[float] = None
    cert_slack: Optional[float] = None
    # host seconds of the RBCD rounds (one cost_trace entry each)
    rbcd_s: float = 0.0


def run(pyfg_path: str, acceleration: bool = True, num_iters: int = 1000,
        r_max: int = 100, rgrad_norm_tol: float = 0.1,
        min_eig_num_tol: float = 1e-3,
        block_selection_rule: BlockSelectionRule = BlockSelectionRule.Greedy,
        init_method: InitializationMethod = InitializationMethod.Odometry,
        rbcd_only: bool = False, verbose: bool = False,
        seed: int = 0, adaptive_stop: bool = True,
        cert_slack_c: float = 1.0, device="cuda",
        lifting_matrix=None) -> MultiRobotRAResult:
    """The JAX driver's run on `device`.  ``adaptive_stop``: when
    certification fails with |theta| inside the O(gradnorm) certificate
    error, tighten the RBCD stop to gradnorm/10 and keep iterating at the
    same rank (see multi_robot_pgo.run).  `lifting_matrix` (rank r -> the
    first robot's [r, d] lifting matrix) replaces jax.random's."""
    t_start = time.time()
    dev = resolve_device(device)
    ds = read_pyfg_file(pyfg_path)
    gm = get_global_measurements(ds)
    robot_meas = get_robot_measurements(ds)
    ridx = robot_global_indices(ds)
    d = ds.dim
    gt = gm.ground_truth_init
    n = gt.n
    robot_ids = frozenset(sorted(ds.robot_IDs))
    first = min(robot_ids)
    rng = np.random.default_rng(seed)
    r_min = d

    if init_method == InitializationMethod.Odometry:
        Xcurr = odometry_init_global(ds, gm)
    elif init_method == InitializationMethod.Random:
        Xcurr = manifold.random_state(
            gt.dims, d, torch.Generator().manual_seed(seed))
    else:
        Xcurr = gt
    Xcurr = Xcurr.to(dev)

    total_iter = 0
    cost_trace: List[float] = []
    grad_trace: List[float] = []
    certified = False
    trajectories: Dict[int, np.ndarray] = {}
    r = r_min
    tol_eff = rgrad_norm_tol
    tightenings = 0
    final_theta = None
    cert_slack = None
    rbcd_s = 0.0

    # the JAX driver's loop condition, kept (see the module docstring)
    while r < r_max:
        central = LocalGraph(0, r, d, GraphType.RangeAidedSLAMGraph)
        central.set_measurements(gm.relative_measurements)
        P = central.problem_data(device=dev)
        G0 = lifted.zeros(central.dims, r, device=dev)

        Xrank = lifted.pad_rank(Xcurr, r) if Xcurr.r < r else Xcurr

        agents: Dict[int, Agent] = {}
        for rid in sorted(robot_ids):
            options = AgentParameters(
                d=d, r=r, robotIDs=robot_ids,
                graphType=GraphType.RangeAidedSLAMGraph,
                acceleration=acceleration, verbose=verbose,
            )
            a = Agent(rid, options, device=dev,
                      lifting_matrix=(lifting_matrix(r) if lifting_matrix
                                      else None))
            if rid != first:
                a.set_lifting_matrix(agents[first].get_lifting_matrix())
            elif a.get_lifting_matrix() is None:
                a.set_lifting_matrix(
                    lifting_matrix(r) if lifting_matrix else
                    manifold.fixed_lifting_matrix(r, d).numpy())
            if rid != MAP_ID:
                a.set_measurements(robot_meas[rid].relative_measurements)
            a.initialize()
            if rid != MAP_ID:
                a.set_X(_slice_agent_state(Xrank, ridx[rid]))
            agents[rid] = a

        active_ids = [rid for rid in sorted(robot_ids) if rid != MAP_ID]
        selected = active_ids[0]
        gradnorm = float("inf")
        Xopt = Xrank
        t_rbcd = time.perf_counter()
        for _ in range(num_iters):
            sel = agents[selected]
            for rid in sorted(robot_ids):
                if rid != selected:
                    agents[rid].iterate(False)
            for rid in sorted(robot_ids):
                if rid == selected:
                    continue
                dicts = agents[rid].get_shared_state_dicts()
                if dicts is None:
                    continue
                sel.set_neighbor_status(agents[rid].get_status())
                sel.update_neighbor_states(rid, dicts[0], False,
                                           dicts[1], dicts[2])
                if acceleration:
                    aux = agents[rid].get_shared_state_dicts(aux=True)
                    sel.update_neighbor_states(rid, aux[0], True,
                                               aux[1], aux[2])
            sel.iterate(True)

            # assemble central estimate
            Xopt = lifted.zeros(gt.dims, r, device=dev)
            for rid in active_ids:
                _scatter_agent_state(Xopt, agents[rid].get_X(), ridx[rid],
                                     n)
            RGrad = riemannian_gradient(P, Xopt, G0)
            # one device->host copy per round: cost, gradnorm and the
            # per-robot block norms of the gradient
            sq = [sum((x ** 2).sum() for x in
                      _slice_agent_state(RGrad, ridx[rid]))
                  for rid in active_ids]
            vals = torch.stack([prob.cost(P, Xopt, G0), RGrad.norm()]
                               + sq).tolist()
            cost, gradnorm = vals[0], vals[1]
            norms = dict(zip(active_ids, np.sqrt(vals[2:]).tolist()))
            cost_trace.append(cost)
            grad_trace.append(gradnorm)
            if verbose or total_iter % 50 == 0:
                print(f"{total_iter} {selected} {cost:.6f} "
                      f"{gradnorm:.6f}")
            if gradnorm < tol_eff:
                break

            if sel.get_neighbors():
                if block_selection_rule == BlockSelectionRule.Greedy:
                    selected = max(norms, key=norms.get)
                else:
                    selected = active_ids[rng.integers(len(active_ids))]
            total_iter += 1
        rbcd_s += time.perf_counter() - t_rbcd

        def finish():
            anchor = agents[first].get_X().pose(0).cpu().numpy()
            for rid in active_ids:
                agents[rid].set_global_anchor(anchor)
                trajectories[rid] = (
                    agents[rid].get_trajectory_in_global_frame()
                )
                agents[rid].reset()

        if rbcd_only:
            finish()
            Xcurr = Xopt
            break

        is_psd, theta, v = fast_verification(
            P, Xopt, min_eig_num_tol,
            num_lanczos=min(64, central.dims.k - 1),
        )
        final_theta = float(theta)
        cert_slack = cert_slack_c * gradnorm
        if not is_psd and adaptive_stop and tightenings < 4 \
                and gradnorm < tol_eff and theta > -cert_slack:
            # inconclusive: |theta| within the O(gradnorm) certificate
            # error; tighten the RBCD stop, continue at this rank
            tol_eff = gradnorm / 10.0
            tightenings += 1
            logger.info(
                "rank %d certificate inconclusive (theta=%.3e, "
                "slack=%.3e): tightening RBCD tol to %.1e",
                r, theta, cert_slack, tol_eff,
            )
            Xcurr = Xopt
            continue
        if is_psd:
            certified = True
            finish()
            Xcurr = Xopt
            break
        logger.info("saddle at rank %d, theta=%.3e", r, theta)
        # second-order alpha + the reference's escape tolerances
        # (MultiRobotExample_RASLAM.cpp:503-505); without M, as the JAX
        # driver
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

    return MultiRobotRAResult(
        X=Xcurr, certified=certified, final_rank=r,
        total_iters=total_iter, cost_trace=cost_trace,
        gradnorm_trace=grad_trace, trajectories=trajectories,
        elapsed_s=time.time() - t_start,
        final_theta=final_theta, cert_slack=cert_slack,
        rbcd_s=rbcd_s,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pyfg")
    ap.add_argument("--no-accel", action="store_true")
    ap.add_argument("--iters", type=int, default=None,
                    help="RBCD rounds (default: rbcd.num_iters, 1000)")
    ap.add_argument("--rmax", type=int, default=None,
                    help="highest rank (default: staircase.r_max, 100)")
    ap.add_argument("--rule", default=None, choices=["Greedy", "Uniform"],
                    help="default: rbcd.block_selection_rule, Greedy")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    DcoraConfig.add_cli(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = DcoraConfig.from_cli(args)
    logger.info("config:\n%s", cfg.dump())
    res = run(
        args.pyfg,
        acceleration=(not args.no_accel) and cfg.rbcd.acceleration,
        num_iters=resolve(args.iters, cfg.rbcd.num_iters),
        r_max=resolve(args.rmax, cfg.staircase.r_max),
        rgrad_norm_tol=cfg.rbcd.rgrad_norm_tol,
        min_eig_num_tol=cfg.staircase.min_eig_num_tol,
        block_selection_rule=BlockSelectionRule[
            resolve(args.rule, cfg.rbcd.block_selection_rule)],
        verbose=args.verbose, device=args.device,
    )
    print(
        f"DCORA: certified={res.certified} rank={res.final_rank} "
        f"iters={res.total_iters} "
        f"final_cost={res.cost_trace[-1]:.6f} elapsed={res.elapsed_s:.1f}s"
    )


if __name__ == "__main__":
    main()
