"""Riemannian staircase: rank-restricted SDP solve with certification.

Counterpart of ``dcora_tpu.staircase`` (reference:
SingleRobotExample_RASLAM.cpp:161-282, MultiRobotExample.cpp:310-363):

  for r = r_min .. r_max:
      X <- RTR local minimum at rank r
      S = Q - Lambda(X); if lambda_min(S) >= -eta: certified, stop
      else: escape saddle along the min-eig direction, lift to rank r+1

On success the solution is rounded to rank d (thin SVD + SO(d) projection)
and refined with a rank-d RTR.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional

import torch

from dcora_tpu_torch.core import lifted, problem as prob
from dcora_tpu_torch.core.certify import (
    escape_saddle,
    fast_verification,
    round_solution,
)
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.rtr import rtr
from dcora_tpu_torch.solvers import (
    FAST_PATH_MIN_POSES,
    make_preconditioner,
    rtr_config_from_params,
    rtr_fast,
)
from dcora_tpu_torch.types import ROptParameters
from dcora_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dcora_tpu_torch.utils.timing import span

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class StaircaseResult:
    X: RAState  # lifted solution at final rank
    rounded: RAState  # rank-d rounded (and refined) solution
    certified: bool
    final_rank: int
    f_final: float
    min_eig_history: List[float] = dataclasses.field(default_factory=list)
    elapsed_s: float = 0.0
    # gradient norm at the certified iterate: the dual certificate is
    # accurate to O(gradnorm), so artifacts record it as the slack
    gradnorm_final: float = float("nan")
    cert_slack: float = float("nan")
    # wall seconds per stage: "solve", "certify", "escape", "round",
    # "refine" (summed over ranks), each ending at a device sync; and the
    # parts of the solve and certify stages, which their solvers add:
    # "solve/build", "solve/tiles_f32", "solve/tiles_f64", "solve/edge"
    # (solvers.rtr_fast) and "certify/blocks", "certify/lanczos",
    # "certify/assemble", "certify/ldlt", "certify/host_eig"
    # (certify.fast_verification)
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def riemannian_staircase(
    g: LocalGraph,
    X0: RAState,
    r_min: int,
    r_max: int,
    opt_params: Optional[ROptParameters] = None,
    min_eig_num_tol: float = 1e-3,
    gradient_tolerance: float = 1e-6,
    preconditioned_gradient_tolerance: float = 1e-6,
    num_lanczos: int = 64,
    refine: bool = True,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
) -> StaircaseResult:
    """Run the staircase on X0's device.  `generator` feeds the Lanczos
    breakdown restarts.  ``checkpoint_path`` persists (X, r) after every
    solver call and every escape in the NPZ format of utils.checkpoint (the
    JAX staircase's), and resumes from it when the file exists."""
    t_start = time.time()
    dev = X0.device
    opt_params = opt_params or ROptParameters(
        gradnorm_tol=1e-4, RTR_iterations=200, RTR_tCG_iterations=200)
    with span("staircase.setup"):
        P = g.problem_data(device=dev)
        M = make_preconditioner(g, P)
        dims = g.dims
        G_prior = prob.linear_term(P, None, dims.n, dims.l, dims.num_trans)
    stage: Dict[str, float] = {}

    def timed(name, fn, *args, **kw):
        with span(name, into=stage):
            out = fn(*args, **kw)
            _sync(dev)
        return out

    def G_at_rank(rr: int):
        if G_prior is None:
            return None
        if G_prior.r < rr:
            return lifted.pad_rank(G_prior, rr)
        return lifted.truncate_rank(G_prior, rr)

    def save(X, r):
        if checkpoint_path:
            save_checkpoint(checkpoint_path, X, r)

    if X0.r != r_min:
        raise ValueError(f"X0 has rank {X0.r}, expected r_min = {r_min}")
    X = X0
    certified = False
    min_eigs: List[float] = []
    TP = None
    r = r_min
    if checkpoint_path and os.path.exists(checkpoint_path):
        X, r, _, _ = load_checkpoint(checkpoint_path, dev)
        logger.info("resuming staircase from checkpoint at rank %d", r)

    cfg = rtr_config_from_params(opt_params)

    def solve_at_rank(X_in, skip_coarse=False):
        nonlocal TP
        if g.n >= FAST_PATH_MIN_POSES:
            res_, TP = rtr_fast(g, P, M, X_in, cfg, G=G_at_rank(r), TP=TP,
                                skip_coarse=skip_coarse, stats=stage)
            return res_
        G = G_at_rank(r)
        return rtr(P, G if G is not None else lifted.zeros(dims, r,
                                                           device=dev),
                   M, X_in, cfg)

    # optimize at EVERY rank entered, including an escape that lands on
    # r_max (reference optimizes each entered rank)
    while True:
        res = timed("solve", solve_at_rank, X)
        X = res.X
        save(X, r)
        # budget exhausted above tolerance: keep optimizing at this rank on
        # the exact edge path (skip_coarse) while the cost still falls
        retries = 0
        res_best = res  # lowest-gradnorm iterate seen at this rank
        while float(res.gradnorm_final) > opt_params.gradnorm_tol \
                and retries < 8:
            f_prev = float(res.f_final)
            res_prev = res
            res = timed("solve", solve_at_rank, X, skip_coarse=True)
            retries += 1
            rel = (f_prev - float(res.f_final)) / max(1.0, abs(f_prev))
            logger.info("rank %d: continue %d: f=%.6f gradnorm=%.3e "
                        "(rel decrease %.1e)", r, retries,
                        float(res.f_final), float(res.gradnorm_final), rel)
            if float(res.gradnorm_final) < float(res_best.gradnorm_final):
                res_best = res
            if rel < 0:
                res = res_prev  # regression (precision floor)
                break
            X = res.X
            save(X, r)
            if retries >= 2 and float(res.gradnorm_final) >= \
                    0.9 * float(res_best.gradnorm_final):
                break
        # certify the LOWEST-gradnorm iterate at this rank
        if float(res_best.gradnorm_final) < float(res.gradnorm_final):
            res = res_best
        X = res.X
        if verbose:
            logger.info("rank %d: f=%.6f gradnorm=%.3e", r,
                        float(res.f_final), float(res.gradnorm_final))
        save(X, r)

        cert_s = stage.get("certify", 0.0)
        is_psd, theta, v = timed(
            "certify", fast_verification, P, X, min_eig_num_tol,
            num_lanczos, TP=(TP.f32 if TP is not None else None),
            generator=generator, times=stage)
        if verbose:
            logger.info("rank %d: certification %.1fs (psd=%s)", r,
                        stage["certify"] - cert_s, is_psd)
        if is_psd:
            certified = True
            break
        min_eigs.append(theta)
        if verbose:
            logger.info("rank %d: saddle, curvature theta=%.3e", r, theta)
        if r >= r_max:
            logger.warning("rank cap r_max=%d reached uncertified", r_max)
            break
        ok, X_next = timed(
            "escape", escape_saddle, P, X, theta, v, r + 1,
            gradient_tolerance=gradient_tolerance,
            preconditioned_gradient_tolerance=(
                preconditioned_gradient_tolerance),
            M=M, is_second_order=True)
        if not ok:
            logger.warning("saddle escape failed at rank %d", r)
            break
        X = X_next
        r += 1
        save(X, r)

    rounded = timed("round", round_solution, X)
    if refine:
        if g.n >= FAST_PATH_MIN_POSES:
            res_r, TP = timed("refine", rtr_fast, g, P, M, rounded, cfg,
                              G=G_at_rank(dims.d), TP=TP)
            rounded = res_r.X
        else:
            G = G_at_rank(dims.d)
            rounded = timed(
                "refine", rtr, P,
                G if G is not None else lifted.zeros(dims, dims.d,
                                                     device=dev),
                M, rounded, cfg).X

    gn_final = float(res.gradnorm_final)
    return StaircaseResult(
        X=X, rounded=rounded, certified=certified, final_rank=r,
        f_final=float(prob.cost(P, X)), min_eig_history=min_eigs,
        elapsed_s=time.time() - t_start, gradnorm_final=gn_final,
        cert_slack=gn_final, stage_seconds=stage,
    )
