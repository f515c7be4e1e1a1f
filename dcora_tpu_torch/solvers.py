"""Batch solvers: single-robot PGO and the mixed-precision RTR phases.

Counterpart of ``dcora_tpu.solvers`` (reference surface: DCORA_solver.cpp
solvePGO, solveRobustPGO, the single and robust rotation, translation and
pose averaging).  The averaging runs on the host in numpy, through the
port's own rotation projection.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from dcora_tpu_torch.core import lifted, problem as prob, tiled
from dcora_tpu_torch.core.device import resolve_device
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import chordal_initialization
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.manifold import project, rotation_project
from dcora_tpu_torch.core.robust import RobustCost
from dcora_tpu_torch.core.rtr import (
    FLAT_BACKEND,
    RA_BACKEND,
    RTRConfig,
    rtr,
    tadd,
    tnorm,
)
from dcora_tpu_torch.measurements import RelativePosePoseMeasurement
from dcora_tpu_torch.types import (
    GraphType,
    ROptParameters,
    RobustCostParameters,
    RobustCostType,
)
from dcora_tpu_torch.utils.timing import span

# below this size the tiled phases cost more than the f64 edge iterations
# they save (the same threshold as the JAX package)
FAST_PATH_MIN_POSES = 500


def rtr_config_from_params(params: ROptParameters,
                           single_step: bool = False) -> RTRConfig:
    return RTRConfig(
        gradnorm_tol=params.gradnorm_tol,
        max_outer=params.RTR_iterations,
        max_inner=params.RTR_tCG_iterations,
        initial_radius=params.RTR_initial_radius,
        single_accepted_step=single_step,
    )


def build_pgo_graph(measurements: List[RelativePosePoseMeasurement],
                    r: Optional[int] = None) -> LocalGraph:
    d = measurements[0].t.shape[0]
    g = LocalGraph(measurements[0].r1, r if r is not None else d, d,
                   GraphType.PoseGraph)
    g.set_measurements(measurements)
    return g


def precond_reg(g: LocalGraph, P: prob.ProblemData) -> float:
    """Reference regularization rule: 1e-1 for PGO, lambda_max/(1e6-1) for
    RA-SLAM (Graph.cpp:1901-1960)."""
    if g.is_pgo_compatible():
        return 1e-1
    probe = lifted.zeros(g.dims, 1, device=P.device)
    return float(prob.power_iteration_lambda_max(P, probe)) / (1e6 - 1.0)


def precond_build() -> str:
    """Which host build make_preconditioner runs: "native" (the C++
    assembly of dcora_tpu_torch.native, when its library is built) or
    "numpy"."""
    from dcora_tpu_torch import native

    return "native" if native.available() else "numpy"


def make_preconditioner(g: LocalGraph, P: prob.ProblemData,
                        reg: Optional[float] = None) -> prob.Preconditioner:
    """Factored block-Jacobi preconditioner of the local Q, built on the
    host and placed on P's device: by the native C++ assembly when its
    library is built (as dcora_tpu.solvers.make_preconditioner; it leaves
    out a prior's quadratic diagonal, as the JAX package's does), else in
    numpy (prob.build_preconditioner_host).  precond_build() says which.
    reg defaults to precond_reg(g, P)."""
    from dcora_tpu_torch import native

    if reg is None:
        reg = precond_reg(g, P)
    if not native.available():
        return prob.build_preconditioner_host(P, g.n, g.l, g.b, g.d, reg)

    def a(x):
        return x.detach().cpu().numpy()

    out = native.jacobi_precond(
        g.n, g.l, g.b, g.d, reg,
        a(P.pp_ri), a(P.pp_rj), a(P.pp_t), a(P.pp_kappa), a(P.pp_tau),
        a(P.pp_w) * a(P.pp_active),
        a(P.pl_ri), a(P.pl_tj), a(P.pl_t), a(P.pl_tau),
        a(P.pl_w) * a(P.pl_active),
        a(P.rg_ti), a(P.rg_tj), a(P.rg_q), a(P.rg_rho), a(P.rg_prec),
        a(P.rg_w) * a(P.rg_active))
    return prob.Preconditioner(*(torch.as_tensor(x, device=P.device)
                                 for x in out))


class TileCache:
    """Lazily-built per-precision tile forms, reused across staircase ranks
    (tiles are rank-independent)."""

    def __init__(self, f32=None, f64=None):
        self.f32 = f32
        self.f64 = f64


def _tile_preconditioner(g: LocalGraph, P: prob.ProblemData):
    """The preconditioner policy of rtr_fast (dcora_tpu/solvers.py:139-172):
    RA problems get the block-tridiagonal RCM-band factorization; PGO gets
    it too when the graph is chain-like (loop closures per pose < 0.2),
    where per-pose Jacobi leaves tCG badly conditioned, and the cheaper
    per-pose blocks otherwise.  Returns build_tiled's tile_precond: "btd",
    True (the diagonal-tile Jacobi) or False (per-pose Jacobi).

    DCORA_RA_PRECOND=btd|tile|pose overrides it on RA problems (any other
    value than btd or pose means tile; pose hands an RA problem to the PGO
    rule below), DCORA_PGO_PRECOND=btd|tile|pose on the rest (any other
    value than btd or tile means pose), as in the JAX package."""
    mode = os.environ.get("DCORA_RA_PRECOND", "btd")
    if g.l > 0 and mode != "pose":
        return "btd" if mode == "btd" else True
    mode_pgo = os.environ.get("DCORA_PGO_PRECOND", "")
    if mode_pgo:
        return "btd" if mode_pgo == "btd" else mode_pgo == "tile"
    m_pp = int(P.pp_ri.shape[0])
    lc_ratio = max(m_pp - (g.n - 1), 0) / max(g.n, 1)
    return "btd" if lc_ratio < 0.2 else False


def rtr_fast(g: LocalGraph, P: prob.ProblemData, M, X0: RAState,
             cfg: RTRConfig, G: Optional[RAState] = None, TP=None,
             skip_coarse: bool = False, stats: Optional[dict] = None):
    """Mixed-precision RTR: f32 tiles -> f64 tiles -> f64 edge path.

      1. flat RCM-tiled backend with f32 tiles;
      2. the same backend with f64 tiles, only if phase 1 stalled above
         tolerance (the assembled Q loses ~6 digits to cancellation near
         optima, so its gradnorm floor sits near 1e-10 * problem scale);
      3. the exact residual-form f64 edge path finishes to cfg.gradnorm_tol
         and produces the returned result.

    Every tile product runs through the SpMM kernel.  The JAX package caps
    each device call by a time estimate to stay inside a TPU RPC watchdog
    (and finishes problems above 150k edges on f64 tiles); none of that
    exists here: each phase is one call, run to tolerance or stall.
    Returns (RTRResult, TileCache); pass the cache back in to reuse tiles.
    The tile builds and the three phases are spans "solve/build",
    "solve/tiles_f32", "solve/tiles_f64" and "solve/edge"; when `stats` is
    a dict, their host seconds are added to it under those names (the
    staircase passes its stage seconds: they are parts of its "solve").
    """
    r = X0.r
    r_pad = max(8, -(-r // 8) * 8)
    if TP is None:
        TP = TileCache()
    tile_pc = _tile_preconditioner(g, P)
    reg = precond_reg(g, P) if tile_pc else 0.1

    def build(dtype):
        with span("solve/build", into=stats):
            return tiled.build_tiled(P, g.dims, dtype=dtype, precond=M,
                                     reg=reg, tile_precond=tile_pc)

    if TP.f32 is None:
        TP.f32 = build(torch.float32)

    def drive_tiled(TPx, X_state, chunk):
        """Tiled RTR at TPx's dtype until tol or stall: after each chunk of
        outer iterations, stop once the gradnorm improved by < 30%."""
        dt = TPx.dtype
        Xf = tiled.to_flat(TPx, X_state, r_pad=r_pad).to(dt)
        Gf = None if G is None else tiled.to_flat(TPx, G, r_pad=r_pad).to(dt)
        cfg_c = dataclasses.replace(
            cfg, gradnorm_tol=max(cfg.gradnorm_tol, 1e-30), max_outer=chunk)
        total = 0
        prev_gn = gn_last = float("inf")
        rad = None
        while total < cfg.max_outer:
            res_t = rtr(TPx, Gf, None, Xf, cfg_c, be=FLAT_BACKEND,
                        radius0=rad)
            Xf, rad = res_t.X, res_t.radius_final
            gn = gn_last = float(res_t.gradnorm_final)
            total += res_t.outer_iters
            if gn < cfg_c.gradnorm_tol or res_t.outer_iters < chunk:
                break
            if gn > 0.7 * prev_gn:
                break  # precision floor: <30% improvement over a chunk
            prev_gn = gn
        X_out = project(tiled.from_flat(TPx, Xf.to(torch.float64), r=r))
        return X_out, gn_last

    # Warm starts that are already near-critical skip the coarse phases:
    # casting such an iterate to f32 degrades it.  One exact edge-path
    # gradnorm probe decides.
    eg0 = RA_BACKEND.applyQ(P, X0)
    if G is not None:
        eg0 = tadd(eg0, G)
    gn0 = float(tnorm(RA_BACKEND.tangent(P, X0, eg0)))
    if skip_coarse or gn0 < 100.0 * cfg.gradnorm_tol:
        X_warm, gn32 = X0, gn0
    else:
        with span("solve/tiles_f32", into=stats):
            X_warm, gn32 = drive_tiled(TP.f32, X0, chunk=25)
    if not skip_coarse and gn32 > cfg.gradnorm_tol \
            and gn0 >= 100.0 * cfg.gradnorm_tol:
        if TP.f64 is None:
            TP.f64 = build(torch.float64)
        with span("solve/tiles_f64", into=stats):
            X_warm, _ = drive_tiled(TP.f64, X_warm, chunk=8)
    with span("solve/edge", into=stats):
        res = rtr(P, G, M, X_warm, cfg)
    return res, TP


def solve_pgo(measurements: List[RelativePosePoseMeasurement],
              params: Optional[ROptParameters] = None,
              T0: Optional[np.ndarray] = None, device="cuda",
              stats: Optional[dict] = None) -> np.ndarray:
    """Single-robot rank-d PGO (reference: DCORA_solver.cpp:304-330) on
    `device` (the card unless the caller asks for the CPU; raises when CUDA
    is absent).

    Returns the optimized trajectory [n, d, d+1].  When `stats` is a dict,
    the host seconds of the chordal init ("init_s", the span "pgo.init"),
    the tile builds ("build_s") and the whole call ("total_s", the span
    "pgo.solve") are added to it."""
    with span("pgo.solve") as total:
        with span("pgo.init") as init:
            device = resolve_device(device)
            params = params or ROptParameters()
            d = measurements[0].t.shape[0]
            T = T0 if T0 is not None else chordal_initialization(
                measurements, device=device)
        g = build_pgo_graph(measurements, r=d)
        P = g.problem_data(device=device)
        M = make_preconditioner(g, P)
        X0 = lifted.from_pose_array(T, device=device)
        cfg = rtr_config_from_params(params)
        G = prob.linear_term(P, None, g.n, g.l, g.dims.num_trans)
        parts = {}
        if g.n >= FAST_PATH_MIN_POSES:
            res, _ = rtr_fast(g, P, M, X0, cfg, G=G, stats=parts)
        else:
            res = rtr(P, G if G is not None
                      else lifted.zeros(g.dims, d, device=device), M, X0,
                      cfg)
        X = res.X
        out = np.zeros((g.n, d, d + 1))
        out[:, :, :d] = X.rot.cpu().numpy()
        out[:, :, d] = X.trn.cpu().numpy()
    if stats is not None:
        stats["init_s"] = stats.get("init_s", 0.0) + init.seconds
        if "solve/build" in parts:
            stats["build_s"] = stats.get("build_s", 0.0) + \
                parts["solve/build"]
        stats["total_s"] = stats.get("total_s", 0.0) + total.seconds
    return out


# --- averaging (reference: DCORA_solver.cpp:30-216) -------------------------


def single_translation_averaging(tVec: List[np.ndarray],
                                 tau: Optional[np.ndarray] = None
                                 ) -> np.ndarray:
    t = np.stack(tVec)
    w = np.ones(len(tVec)) if tau is None else np.asarray(tau)
    return (w[:, None] * t).sum(0) / w.sum()


def single_rotation_averaging(RVec: List[np.ndarray],
                              kappa: Optional[np.ndarray] = None
                              ) -> np.ndarray:
    R = np.stack(RVec)
    w = np.ones(len(RVec)) if kappa is None else np.asarray(kappa)
    M = (w[:, None, None] * R).sum(0)
    return rotation_project(torch.as_tensor(M, dtype=torch.float64)).numpy()


def single_pose_averaging(RVec, tVec, kappa=None, tau=None):
    return (single_rotation_averaging(RVec, kappa),
            single_translation_averaging(tVec, tau))


def _gnc_averaging_loop(update_fn, residual_fn, n, barc):
    """Shared GNC-TLS loop for robust averaging
    (reference: DCORA_solver.cpp:76-216)."""
    w_tol = 1e-8
    weights = np.ones(n)
    est = update_fn(weights)
    rsq = residual_fn(est)
    barc_sq = barc * barc
    mu_init = min(barc_sq / (2 * rsq.max() - barc_sq), 1e-5)
    if mu_init > 0:
        cost = RobustCost(RobustCostParameters(
            costType=RobustCostType.GNC_TLS, GNCBarc=barc,
            GNCMaxNumIters=1000, GNCInitMu=mu_init))
        for _ in range(cost.params.GNCMaxNumIters):
            est = update_fn(weights)
            rsq = residual_fn(est)
            weights = cost.weight(np.sqrt(rsq))
            if np.sum((weights < w_tol) | (weights > 1 - w_tol)) == n:
                break
            cost.update()
    inliers = [i for i in range(n) if weights[i] > 1 - w_tol]
    return est, inliers, weights


def robust_single_rotation_averaging(RVec: List[np.ndarray],
                                     kappa: Optional[np.ndarray] = None,
                                     error_threshold: float = 1.0):
    """GNC-TLS robust rotation averaging
    (reference: DCORA_solver.cpp:76-134). Returns (ROpt, inlier_indices)."""
    n = len(RVec)
    kap = np.ones(n) if kappa is None else np.asarray(kappa)
    R = np.stack(RVec)

    def update(weights):
        return single_rotation_averaging(RVec, kap * weights)

    def residual(ROpt):
        return kap * ((ROpt[None] - R) ** 2).sum(axis=(1, 2))

    est, inliers, _ = _gnc_averaging_loop(update, residual, n,
                                          error_threshold)
    return est, inliers


def robust_single_pose_averaging(RVec, tVec, kappa=None, tau=None,
                                 error_threshold: float = 1.0):
    """GNC-TLS robust pose averaging (reference: DCORA_solver.cpp:136-216).
    Returns (ROpt, tOpt, inlier_indices)."""
    n = len(RVec)
    kap = 10000 * np.ones(n) if kappa is None else np.asarray(kappa)
    ta = 100 * np.ones(n) if tau is None else np.asarray(tau)
    R = np.stack(RVec)
    t = np.stack(tVec)

    def update(weights):
        return single_pose_averaging(RVec, tVec, kap * weights, ta * weights)

    def residual(est):
        ROpt, tOpt = est
        return (kap * ((ROpt[None] - R) ** 2).sum(axis=(1, 2))
                + ta * ((tOpt[None] - t) ** 2).sum(axis=1))

    est, inliers, _ = _gnc_averaging_loop(update, residual, n,
                                          error_threshold)
    return est[0], est[1], inliers


def compute_measurement_error(m: RelativePosePoseMeasurement,
                              R1, t1, R2, t2) -> float:
    """kappa*||R1 R_m - R2||^2 + tau*||t2 - t1 - R1 t_m||^2
    (reference: DCORA_utils.cpp:2095-2101)."""
    rot_err = float(((R1 @ m.R - R2) ** 2).sum())
    tr_err = float(((t2 - t1 - R1 @ m.t) ** 2).sum())
    return m.kappa * rot_err + m.tau * tr_err


@dataclasses.dataclass
class SolveRobustPGOParams:
    """reference: DCORA_solver.h solveRobustPGOParams."""

    opt_params: ROptParameters = dataclasses.field(
        default_factory=lambda: ROptParameters(
            gradnorm_tol=1.0, RTR_iterations=20
        )
    )
    robust_params: RobustCostParameters = dataclasses.field(
        default_factory=RobustCostParameters
    )
    verbose: bool = False


def solve_robust_pgo(measurements: List[RelativePosePoseMeasurement],
                     params: Optional[SolveRobustPGOParams] = None,
                     T0: Optional[np.ndarray] = None, device="cuda",
                     stats: Optional[list] = None) -> np.ndarray:
    """GNC outer loop around solve_pgo, mutating measurement weights in
    place (reference: DCORA_solver.cpp:332-409).  Every stage rebuilds the
    graph, the tiles and (without T0) the chordal init on `device`.  When
    `stats` is a list, one solve_pgo stats dict per stage is appended."""
    device = resolve_device(device)
    params = params or SolveRobustPGOParams()
    w_tol = 1e-8

    def stage():
        st = None if stats is None else {}
        T = solve_pgo(measurements, params.opt_params, T0, device=device,
                      stats=st)
        if stats is not None:
            stats.append(st)
        return T

    def residuals(T):
        return np.array([compute_measurement_error(
            m, T[m.p1, :, :-1], T[m.p1, :, -1], T[m.p2, :, :-1],
            T[m.p2, :, -1]) for m in measurements])

    T = stage()
    for m in measurements:
        m.weight = 1.0
    rsq = residuals(T)
    barc_sq = params.robust_params.GNCBarc ** 2
    mu_init = barc_sq / (2 * rsq.max() - barc_sq)
    if mu_init > 0:
        cost = RobustCost(dataclasses.replace(
            params.robust_params, GNCInitMu=mu_init,
            costType=RobustCostType.GNC_TLS))
        for it in range(cost.params.GNCMaxNumIters):
            T = stage()
            rsq = residuals(T)
            num_undecided = 0
            for i, m in enumerate(measurements):
                if m.fixedWeight:
                    continue
                m.weight = float(cost.weight(np.sqrt(rsq[i])))
                if w_tol <= m.weight <= 1 - w_tol:
                    num_undecided += 1
            if params.verbose:
                print(f"[solve_robust_pgo] iter {it}: "
                      f"{num_undecided} undecided")
            if num_undecided == 0:
                break
            cost.update()
    return stage()


__all__ = [
    "FAST_PATH_MIN_POSES",
    "SolveRobustPGOParams",
    "TileCache",
    "build_pgo_graph",
    "compute_measurement_error",
    "make_preconditioner",
    "precond_reg",
    "resolve_device",
    "robust_single_pose_averaging",
    "robust_single_rotation_averaging",
    "rtr_config_from_params",
    "rtr_fast",
    "single_pose_averaging",
    "single_rotation_averaging",
    "single_translation_averaging",
    "solve_pgo",
    "solve_robust_pgo",
]
