"""Batch solvers: single-robot PGO and the mixed-precision RTR phases.

Counterpart of the main-path part of ``dcora_tpu.solvers``
(reference surface: DCORA_solver.cpp solvePGO).  The robust GNC solvers and
the averaging functions are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from dcora_tpu_torch.core import lifted, problem as prob, tiled
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import chordal_initialization
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.manifold import project
from dcora_tpu_torch.core.rtr import (
    FLAT_BACKEND,
    RA_BACKEND,
    RTRConfig,
    rtr,
    tadd,
    tnorm,
)
from dcora_tpu_torch.measurements import RelativePosePoseMeasurement
from dcora_tpu_torch.types import GraphType, ROptParameters

# below this size the tiled phases cost more than the f64 edge iterations
# they save (the same threshold as the JAX package)
FAST_PATH_MIN_POSES = 500


def resolve_device(device) -> torch.device:
    """The named device, or an error when it is not available (the port's
    entry points never fall back to another device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def rtr_config_from_params(params: ROptParameters) -> RTRConfig:
    return RTRConfig(
        gradnorm_tol=params.gradnorm_tol,
        max_outer=params.RTR_iterations,
        max_inner=params.RTR_tCG_iterations,
        initial_radius=params.RTR_initial_radius,
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


def make_preconditioner(g: LocalGraph, P: prob.ProblemData
                        ) -> prob.Preconditioner:
    """Factored block-Jacobi preconditioner of the local Q, built on the
    host in numpy and placed on P's device."""
    return prob.build_preconditioner_host(P, g.n, g.l, g.b, g.d,
                                          precond_reg(g, P))


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
    per-pose blocks otherwise."""
    if g.l > 0:
        return "btd"
    m_pp = int(P.pp_ri.shape[0])
    lc_ratio = max(m_pp - (g.n - 1), 0) / max(g.n, 1)
    return "btd" if lc_ratio < 0.2 else False


def rtr_fast(g: LocalGraph, P: prob.ProblemData, M, X0: RAState,
             cfg: RTRConfig, G: Optional[RAState] = None, TP=None,
             skip_coarse: bool = False):
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
    """
    r = X0.r
    r_pad = max(8, -(-r // 8) * 8)
    if TP is None:
        TP = TileCache()
    tile_pc = _tile_preconditioner(g, P)
    reg = precond_reg(g, P) if tile_pc else 0.1
    if TP.f32 is None:
        TP.f32 = tiled.build_tiled(P, g.dims, dtype=torch.float32,
                                   precond=M, reg=reg,
                                   tile_precond=tile_pc)

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
        X_warm, gn32 = drive_tiled(TP.f32, X0, chunk=25)
    if not skip_coarse and gn32 > cfg.gradnorm_tol \
            and gn0 >= 100.0 * cfg.gradnorm_tol:
        if TP.f64 is None:
            TP.f64 = tiled.build_tiled(P, g.dims, dtype=torch.float64,
                                       precond=M, reg=reg,
                                       tile_precond=tile_pc)
        X_warm, _ = drive_tiled(TP.f64, X_warm, chunk=8)
    return rtr(P, G, M, X_warm, cfg), TP


def solve_pgo(measurements: List[RelativePosePoseMeasurement],
              params: Optional[ROptParameters] = None,
              T0: Optional[np.ndarray] = None, device="cuda") -> np.ndarray:
    """Single-robot rank-d PGO (reference: DCORA_solver.cpp:304-330) on
    `device` (the card unless the caller asks for the CPU; raises when CUDA
    is absent).

    Returns the optimized trajectory [n, d, d+1]."""
    device = resolve_device(device)
    params = params or ROptParameters()
    d = measurements[0].t.shape[0]
    T = T0 if T0 is not None else chordal_initialization(measurements)
    g = build_pgo_graph(measurements, r=d)
    P = g.problem_data(device=device)
    M = make_preconditioner(g, P)
    X0 = lifted.from_pose_array(T, device=device)
    cfg = rtr_config_from_params(params)
    G = prob.linear_term(P, None, g.n, g.l, g.dims.num_trans)
    if g.n >= FAST_PATH_MIN_POSES:
        res, _ = rtr_fast(g, P, M, X0, cfg, G=G)
    else:
        res = rtr(P, G if G is not None
                  else lifted.zeros(g.dims, d, device=device), M, X0, cfg)
    X = res.X
    out = np.zeros((g.n, d, d + 1))
    out[:, :, :d] = X.rot.cpu().numpy()
    out[:, :, d] = X.trn.cpu().numpy()
    return out


__all__ = [
    "FAST_PATH_MIN_POSES",
    "TileCache",
    "build_pgo_graph",
    "make_preconditioner",
    "precond_reg",
    "resolve_device",
    "rtr_config_from_params",
    "rtr_fast",
    "solve_pgo",
]
