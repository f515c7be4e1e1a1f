"""Trajectory initialization: odometry chaining and chordal relaxation.

Counterpart of ``dcora_tpu.core.init``.  Chordal initialization (reference:
DCORA_solver.cpp:218-268, B matrices DCORA_utils.cpp:1542-1659) solves two
sparse least-squares problems; the reference uses SPQR, this solves the
graph-Laplacian normal equations matrix-free with degree-preconditioned CG:

  rotations:    min_R sum_e kappa_e ||R_j - R_i R_e||_F^2,  R_0 = I
  translations: min_t sum_e tau_e   ||t_j - t_i - R_i t_e||^2,  t_0 = 0

It runs on the caller's device, the card by default.  (The JAX package pins
it to the CPU to stay inside a TPU RPC watchdog; that workaround is not
ported.)
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from dcora_tpu_torch.core.device import resolve_device
from dcora_tpu_torch.core.manifold import rotation_project
from dcora_tpu_torch.measurements import RelativePosePoseMeasurement


def odometry_initialization(odometry: List[RelativePosePoseMeasurement],
                            partial_trajectory: Optional[np.ndarray] = None
                            ) -> np.ndarray:
    """Chain odometry into a trajectory [n, d, d+1].

    reference: DCORA_solver.cpp:270-302. odometry[k] must connect k -> k+1.
    """
    if not odometry:
        raise ValueError("empty odometry")
    d = odometry[0].t.shape[0]
    n = max(max(m.p1, m.p2) for m in odometry) + 1
    T = np.zeros((n, d, d + 1))
    if partial_trajectory is not None and len(partial_trajectory) > 0:
        m = min(len(partial_trajectory), n)
        T[:m] = partial_trajectory[:m]
        next_index = m
    else:
        T[0, :, :d] = np.eye(d)
        next_index = 1
    odo = {m.p1: m for m in odometry}
    for dst in range(next_index, n):
        m = odo[dst - 1]
        if m.p1 != dst - 1 or m.p2 != dst:
            raise ValueError(f"odometry edge {m.p1}->{m.p2} out of chain")
        R_src = T[dst - 1, :, :d]
        T[dst, :, :d] = R_src @ m.R
        T[dst, :, d] = T[dst - 1, :, d] + R_src @ m.t
    return T


def _seg(contrib, idx, n):
    out = torch.zeros((n,) + contrib.shape[1:], dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, idx, contrib)


# CG reads its stopping rule on the host every this many iterations (each
# read waits for the device)
CG_READ_EVERY = 32


def cg(A: Callable, b: torch.Tensor, M: Callable, tol: float,
       maxiter: int, iters: Optional[list] = None) -> torch.Tensor:
    """Preconditioned CG from x0 = 0, stopping once ||r||^2 <= tol^2 ||b||^2
    (the rule and update order of jax.scipy.sparse.linalg.cg).

    Every update is masked by that rule, so iterations issued after the
    stopping one change nothing, and the host reads the rule only every
    CG_READ_EVERY iterations.  When `iters` is a list, the count of
    iterations that updated x is appended to it."""
    atol2 = tol * tol * torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b.clone()
    z = M(r)
    p = z
    gamma = torch.sum(r * z)
    n_live = torch.zeros((), dtype=torch.int64, device=b.device)
    for it in range(maxiter):
        live = torch.sum(r * r) > atol2
        if it % CG_READ_EVERY == 0 and not bool(live):
            break
        if iters is not None:
            n_live += live
        Ap = A(p)
        alpha = gamma / torch.sum(p * Ap)
        x = torch.where(live, x + alpha * p, x)
        r_new = r - alpha * Ap
        z_new = M(r_new)
        gamma_new = torch.sum(r_new * z_new)
        p = torch.where(live, z_new + (gamma_new / gamma) * p, p)
        r = torch.where(live, r_new, r)
        gamma = torch.where(live, gamma_new, gamma)
    if iters is not None:
        iters.append(int(n_live))
    return x


def _chordal_rotations(ii, jj, Rm, kappa, n: int,
                       iters: Optional[list] = None) -> torch.Tensor:
    """Pinned rotation Laplacian system (row 0 fixed to I), Jacobi-PCG."""
    d = Rm.shape[1]

    def lap(X):
        Xi = X[ii]
        Xj = X[jj]
        c_i = kappa[:, None, None] * (Xi - torch.einsum("mre,mde->mrd",
                                                        Xj, Rm))
        c_j = kappa[:, None, None] * (Xj - torch.einsum("mre,med->mrd",
                                                        Xi, Rm))
        return _seg(torch.cat([c_i, c_j]), torch.cat([ii, jj]), n)

    mask = (torch.arange(n, device=Rm.device) > 0)[:, None, None]

    def A(x):
        return torch.where(mask, lap(torch.where(mask, x, 0.0)), 0.0)

    X0 = torch.zeros((n, d, d), dtype=Rm.dtype, device=Rm.device)
    X0[0] = torch.eye(d, dtype=Rm.dtype, device=Rm.device)
    b = torch.where(mask, -lap(X0), 0.0)
    deg = _seg(torch.cat([kappa, kappa]), torch.cat([ii, jj]), n)
    deg = torch.where(deg == 0, 1.0, deg)[:, None, None]
    x = cg(A, b, lambda v: v / deg, tol=1e-12, maxiter=20 * n, iters=iters)
    return X0 + x


def _recover_translations(ii, jj, tm, tau, R, n: int,
                          iters: Optional[list] = None) -> torch.Tensor:
    """Pinned translation Laplacian (reference: recoverTranslations,
    DCORA_utils.cpp:1633-1659)."""

    def lap(t):
        diff = tau[:, None] * (t[ii] - t[jj])
        return _seg(torch.cat([diff, -diff]), torch.cat([ii, jj]), n)

    mask = (torch.arange(n, device=tm.device) > 0)[:, None]

    def A(x):
        return torch.where(mask, lap(torch.where(mask, x, 0.0)), 0.0)

    Rt = torch.einsum("mde,me->md", R[ii], tm)  # R_i t_e
    rhs = _seg(torch.cat([-tau[:, None] * Rt, tau[:, None] * Rt]),
               torch.cat([ii, jj]), n)
    b = torch.where(mask, rhs, 0.0)
    deg = _seg(torch.cat([tau, tau]), torch.cat([ii, jj]), n)
    deg = torch.where(deg == 0, 1.0, deg)[:, None]
    return cg(A, b, lambda v: v / deg, tol=1e-12, maxiter=20 * n,
              iters=iters)


def chordal_initialization(measurements: List[RelativePosePoseMeasurement],
                           device="cuda",
                           cg_iters: Optional[list] = None) -> np.ndarray:
    """Chordal initialization -> [n, d, d+1] (reference:
    DCORA_solver.cpp:218-268), solved on `device` (the card unless the
    caller asks for the CPU; raises when CUDA is absent).  When `cg_iters`
    is a list, the CG iterations of the rotation and of the translation
    solve are appended to it."""
    device = resolve_device(device)
    if not measurements:
        raise ValueError("no measurements")
    d = measurements[0].t.shape[0]
    n = max(max(m.p1, m.p2) for m in measurements) + 1
    f64 = dict(dtype=torch.float64, device=device)
    ii = torch.as_tensor([m.p1 for m in measurements], device=device)
    jj = torch.as_tensor([m.p2 for m in measurements], device=device)
    Rm = torch.as_tensor(np.stack([m.R for m in measurements]), **f64)
    tm = torch.as_tensor(np.stack([m.t for m in measurements]), **f64)
    kappa = torch.as_tensor([m.kappa * m.weight for m in measurements], **f64)
    tau = torch.as_tensor([m.tau * m.weight for m in measurements], **f64)

    X = _chordal_rotations(ii, jj, Rm, kappa, n, cg_iters)
    R = rotation_project(X)
    t = _recover_translations(ii, jj, tm, tau, R, n, cg_iters)

    T = np.zeros((n, d, d + 1))
    T[:, :, :d] = R.cpu().numpy()
    T[:, :, d] = t.cpu().numpy()
    return T
