"""Optimality certification: dual certificate, Lanczos min-eig, saddle escape.

Counterpart of ``dcora_tpu.core.certify``.  Replaces the reference's
CHOLMOD PSD check + Spectra eigensolvers (DCORA_utils.cpp:1713-1982) with a
matrix-free Lanczos (full reorthogonalization) over S = Q - Lambda(X),
following the SE-Sync spectrum-shifting strategy (DCORA_utils.cpp:1807-1896):

  1. lambda_lm <- largest-magnitude eigenvalue of S.  If negative, it IS the
     minimum eigenvalue.
  2. Otherwise run Lanczos on S - 2*lambda_lm*I (all eigenvalues negative);
     its largest-magnitude eigenvalue + 2*lambda_lm is lambda_min(S).

A PSD verdict is confirmed on the host by an LDL^T inertia proof (scipy,
unchanged from the JAX package).  Also the saddle-escape line search
(QuadraticProblem.cpp:138-234) and rank-d rounding (DCORA_utils.cpp:
1984-2031).

Lanczos restarts after a breakdown draw from an injected torch.Generator
(the JAX package draws from jax.random, whose stream torch cannot
reproduce); the start vectors are numpy-made and carry over exactly.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dcora_tpu_torch.core import lifted, problem as prob, tiled
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.manifold import (
    oblique_project,
    retract,
    rotation_project,
    tangent_project,
)
from dcora_tpu_torch.core.problem import ProblemData
from dcora_tpu_torch.types import ProblemDims


class Certificate(NamedTuple):
    """Lambda(X) blocks of the dual certificate S = Q - Lambda."""

    rot_blocks: torch.Tensor  # [n, d, d] symmetric Stiefel multipliers
    sph_diag: torch.Tensor  # [l] oblique multipliers


def dual_certificate_blocks(P: ProblemData, X: RAState) -> Certificate:
    """Lambda blocks (reference: constructDualCertificateMatrixPGO/RASLAM,
    DCORA_utils.cpp:1898-1982)."""
    W = prob.apply_Q(P, X)
    Prot = torch.einsum("nri,nrj->nij", W.rot, X.rot)
    return Certificate(rot_blocks=0.5 * (Prot + Prot.transpose(1, 2)),
                       sph_diag=(X.sph * W.sph).sum(dim=-1))


def apply_S(P: ProblemData, C: Certificate, V: RAState) -> RAState:
    """V S = V Q - V Lambda."""
    W = prob.apply_Q(P, V)
    return RAState(
        rot=W.rot - torch.einsum("nrd,nde->nre", V.rot, C.rot_blocks),
        sph=W.sph - V.sph * C.sph_diag[:, None],
        trn=W.trn,
    )


def _default_generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


# --------------------------------------------------------------------------
# Matrix-free Lanczos with full reorthogonalization
# --------------------------------------------------------------------------


def _flat_matvec(P: ProblemData, C: Certificate, dims: ProblemDims, shift):
    def mv(v):  # v: [k]
        V = lifted.from_flat(v[None, :], dims)
        return lifted.to_flat(apply_S(P, C, V))[0] + shift * v

    return mv


def _lanczos(mv, v0: torch.Tensor, m: int, breakdown: float,
             generator: torch.Generator):
    """m Lanczos steps with two-pass full reorthogonalization.

    Returns (alphas, betas, basis).  After a lucky breakdown (beta below
    `breakdown`) the next vector is a fresh random direction orthogonal to
    the basis, drawn from `generator`.  No host sync inside the loop."""
    k = v0.shape[0]
    basis = torch.zeros((m, k), dtype=v0.dtype, device=v0.device)
    alphas = torch.zeros(m, dtype=v0.dtype, device=v0.device)
    betas = torch.zeros(m, dtype=v0.dtype, device=v0.device)
    v = v0 / torch.linalg.vector_norm(v0)
    for j in range(m):
        basis[j] = v
        w = mv(v)
        alphas[j] = torch.dot(v, w)
        for _ in range(2):
            w = w - basis.T @ (basis @ w)
        b = torch.linalg.vector_norm(w)
        betas[j] = b
        fresh = torch.randn(k, generator=generator, dtype=v0.dtype,
                            device=v0.device)
        for _ in range(2):
            fresh = fresh - basis.T @ (basis @ fresh)
        fresh = fresh / torch.clamp(torch.linalg.vector_norm(fresh),
                                    min=1e-300 if v0.dtype == torch.float64
                                    else 1e-30)
        v = torch.where(b > breakdown,
                        w / torch.where(b == 0, torch.ones_like(b), b), fresh)
    return alphas, betas, basis


def _ritz_extreme(alphas, betas, basis):
    """Largest-magnitude Ritz pair and its residual bound."""
    Tm = torch.diag(alphas) + torch.diag(betas[:-1], 1) + \
        torch.diag(betas[:-1], -1)
    evals, evecs = torch.linalg.eigh(Tm)
    idx = torch.argmax(evals.abs())
    y = basis.T @ evecs[:, idx]
    resid = (betas[-1] * evecs[-1, idx]).abs()
    return evals[idx], y, resid


def minimum_eigen_pair(P: ProblemData, C: Certificate, dims: ProblemDims,
                       num_lanczos: int = 64,
                       v0: Optional[np.ndarray] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[float, torch.Tensor, float]:
    """(lambda_min, eigvec [k], residual) of S via spectrum shifting."""
    dev = C.rot_blocks.device
    f64 = dict(dtype=torch.float64, device=dev)
    gen = generator or _default_generator(dev)
    m = min(num_lanczos, dims.k)
    if v0 is None:
        v0 = np.random.default_rng(0).standard_normal(dims.k)
    v0 = torch.as_tensor(v0, **f64)

    mv0 = _flat_matvec(P, C, dims, 0.0)
    lam_lm, y_lm, res_lm = _ritz_extreme(*_lanczos(mv0, v0, m, 1e-12, gen))
    lam_lm_f = float(lam_lm)
    if lam_lm_f < 0:
        return lam_lm_f, y_lm, float(res_lm)

    # shift: S - 2 lambda_lm I has all eigenvalues negative; v0 heuristic:
    # perturbed S e0 row (reference: DCORA_utils.cpp:1861-1866)
    e0 = torch.zeros(dims.k, **f64)
    e0[0] = 1.0
    row0 = mv0(e0)
    rng = np.random.default_rng(1)
    pert = rng.standard_normal(dims.k)
    pert /= np.linalg.norm(pert)
    v0s = row0 + 0.03 * torch.linalg.vector_norm(row0) * \
        torch.as_tensor(pert, **f64)
    if float(torch.linalg.vector_norm(v0s)) < 1e-12:
        v0s = torch.as_tensor(rng.standard_normal(dims.k), **f64)

    # restarted sweeps seeded with the current Ritz vector; stop after two
    # consecutive stagnant sweeps (a single sweep can miss a clustered
    # bottom eigenvalue)
    mvs = _flat_matvec(P, C, dims, -2.0 * lam_lm)
    lam_best, y_best, res_best = None, None, 0.0
    stagnant = 0
    for _ in range(40):
        lam_s, y_s, res_s = _ritz_extreme(*_lanczos(mvs, v0s, m, 1e-12, gen))
        lam_cur = float(lam_s + 2.0 * lam_lm)
        if lam_best is not None and \
                lam_cur > lam_best - max(1e-12, 1e-9 * abs(lam_lm_f)):
            stagnant += 1
            if stagnant >= 2:
                break
        else:
            stagnant = 0
        if lam_best is None or lam_cur < lam_best:
            lam_best, y_best, res_best = lam_cur, y_s, float(res_s)
        v0s = y_s
    return lam_best, y_best, res_best


# --------------------------------------------------------------------------
# Flat tiled Lanczos: the S matvec in the flat basis is apply_tiled minus
# weingarten_apply; it runs the SpMM kernel at the tile dtype with one live
# row of an r_pad = 8 operand.
# --------------------------------------------------------------------------


def _lanczos_extreme_flat(TP, aux, shift, v0: torch.Tensor, m: int,
                          generator: torch.Generator):
    kpad = v0.shape[0]
    r_pad = 8  # rows 1.. stay zero

    def mv(v):
        V = torch.zeros((r_pad, kpad), dtype=v.dtype, device=v.device)
        V[0] = v
        W = tiled.apply_tiled(TP, V) - tiled.weingarten_apply(TP.meta, V, aux)
        return W[0] + shift * v

    alphas, betas, basis = _lanczos(mv, v0, m, 1e-7, generator)
    lam, y, _ = _ritz_extreme(alphas, betas, basis)
    return lam, y


def minimum_eigen_pair_tiled(TP, X: RAState, num_lanczos: int = 64,
                             generator: Optional[torch.Generator] = None):
    """(lambda_min estimate, RA-flat eigenvector [k] in f64) via the tiled
    S operator at the tile dtype; PSD conclusions must be validated at f64
    (see fast_verification)."""
    meta = TP.meta
    dt = TP.dtype
    gen = generator or _default_generator(TP.device)
    r_pad = max(8, -(-X.r // 8) * 8)
    Xf = tiled.to_flat(TP, X, r_pad=r_pad).to(dt)
    aux = tiled.weingarten_setup(meta, Xf, tiled.apply_tiled(TP, Xf))

    m = min(num_lanczos, meta.k)
    v0 = np.zeros(meta.kpad)
    v0[:meta.k] = np.random.default_rng(0).standard_normal(meta.k)
    v0 = torch.as_tensor(v0, dtype=dt, device=TP.device)

    def ra(y):
        Y = tiled.from_flat(TP, y[None].to(torch.float64))
        return lifted.to_flat(Y)[0]

    zero = torch.zeros((), dtype=dt, device=TP.device)
    lam_lm, y_lm = _lanczos_extreme_flat(TP, aux, zero, v0, m, gen)
    lam_lm_f = float(lam_lm)
    if lam_lm_f < 0:
        return lam_lm_f, ra(y_lm)
    lam_best, y_best = None, None
    stagnant = 0
    for _ in range(20):
        lam_s, y_s = _lanczos_extreme_flat(TP, aux, -2.0 * lam_lm, v0, m,
                                           gen)
        lam_cur = float(lam_s + 2.0 * lam_lm_f)
        if lam_best is not None and \
                lam_cur > lam_best - 1e-6 * abs(lam_lm_f):
            stagnant += 1
            if stagnant >= 2:
                break
        else:
            stagnant = 0
        if lam_best is None or lam_cur < lam_best:
            lam_best, y_best = lam_cur, y_s
        v0 = y_s
    return lam_best, ra(y_best)


# --------------------------------------------------------------------------
# Host (scipy) certification, unchanged from the JAX package
# --------------------------------------------------------------------------


def _Q_host(P: ProblemData, dims: ProblemDims):
    """Exact scipy CSR of the local Q in RA ordering, assembled host-side
    from the same closed-form blocks as the tile build."""
    import scipy.sparse as sp

    n, l, d = dims.n, dims.l, dims.d  # noqa: E741
    # RA ordering: rot (i, a) -> i*d + a, sphere q -> n*d + q,
    # translation t -> n*d + l + t; augmented (fixed) slots fall off the
    # ends of these maps and are dropped
    rot_base = np.arange(n) * d
    trn_col = n * d + l + np.arange(dims.num_trans)
    sph_col = n * d + np.arange(l) if l else np.full(1, -1)
    rows, cols, vals = tiled.scalar_coo(P, dims, rot_base, trn_col, sph_col)
    k = dims.k
    return sp.coo_matrix((vals, (rows, cols)), shape=(k, k)).tocsr()


def _assemble_S_host(P: ProblemData, C: Certificate, dims: ProblemDims):
    """scipy CSR of S = Q - Lambda(X) (DCORA_utils.cpp:1898-1982)."""
    import scipy.sparse as sp

    k = dims.k
    n, d, l = dims.n, dims.d, dims.l  # noqa: E741
    Q = _Q_host(P, dims)
    rot = C.rot_blocks.detach().cpu().numpy()  # [n, d, d]
    rows = (np.arange(n)[:, None, None] * d
            + np.broadcast_to(np.arange(d)[:, None], (n, d, d)))
    cols = (np.arange(n)[:, None, None] * d
            + np.broadcast_to(np.arange(d)[None, :], (n, d, d)))
    lam_rows = np.concatenate([rows.ravel(), n * d + np.arange(l)])
    lam_cols = np.concatenate([cols.ravel(), n * d + np.arange(l)])
    lam_vals = np.concatenate([rot.ravel(),
                               C.sph_diag.detach().cpu().numpy()])
    Lam = sp.coo_matrix((lam_vals, (lam_rows, lam_cols)),
                        shape=(k, k)).tocsr()
    return Q - Lam


def ldl_psd_proof(S) -> Optional[bool]:
    """Factorization-grade PSD proof of a sparse symmetric matrix.

    A symmetric-permuted LDL^T via SuperLU in SymmetricMode with diagonal
    pivoting forced (diag_pivot_thresh=0).  When perm_r == perm_c the
    permuted matrix factors as L D L^T, so by Sylvester's law the signs of
    diag(U) are the inertia of S (the analogue of the reference's CHOLMOD
    quick-return, DCORA_utils.cpp:1737-1747).

    Returns True (S is PD), False (S has a negative eigenvalue) or None
    (inconclusive).
    """
    from scipy.sparse.linalg import splu

    try:
        lu = splu(S.tocsc(), diag_pivot_thresh=0.0,
                  permc_spec="MMD_AT_PLUS_A",
                  options=dict(SymmetricMode=True))
    except (RuntimeError, ValueError, MemoryError):
        return None
    if not np.array_equal(lu.perm_r, lu.perm_c):
        return None  # off-diagonal pivoting: congruence argument void
    diag = lu.U.diagonal()
    scale = float(np.abs(diag).max()) if diag.size else 0.0
    tiny = 1e-12 * max(scale, 1.0)
    if float(diag.min()) > tiny:
        return True
    if float(diag.min()) < -tiny:
        return False
    return None


def _inertia_bracket_min_eig(S, eta: float, max_doublings: int = 40,
                             bisections: int = 10):
    """Bracket -lambda_min(S) with the LDL^T inertia oracle, given that
    S + eta*I is proven indefinite: double t until S + t*I factors PD, then
    bisect.  Returns (lo, hi) or None."""
    import scipy.sparse as sp

    eye = sp.identity(S.shape[0], format="csc")
    lo, hi = eta, None
    t = max(2.0 * eta, 1e-10)
    for _ in range(max_doublings):
        pr = ldl_psd_proof(S + t * eye)
        if pr is True:
            hi = t
            break
        if pr is False:
            lo = t
        t *= 2.0
    if hi is None:
        return None
    for _ in range(bisections):
        mid = 0.5 * (lo + hi)
        pr = ldl_psd_proof(S + mid * eye)
        if pr is True:
            hi = mid
        elif pr is False:
            lo = mid
        else:
            break
    return lo, hi


def _min_eig_host(P: ProblemData, C: Certificate, dims: ProblemDims,
                  eta: float = 0.0
                  ) -> Tuple[bool, float, Optional[np.ndarray]]:
    """Fail-closed host check of lambda_min(S) >= -eta.

    Returns (certified, rayleigh, v):
      1. LDL^T proof of S + eta*I (an actual factorization witness);
      2. otherwise ARPACK on shift*I - S with an explicit residual check,
         LOBPCG fallback;
      3. fail closed: never certify from an unconverged vector.
    A negative Rayleigh quotient below -eta is a sound indefiniteness proof.

    Every ARPACK call starts from a vector of a seeded generator: without
    one ARPACK draws its start from a stream it keeps across calls in the
    process, so the same S gives another estimate (in its last digits) on
    every call.  The JAX package leaves two of the calls unseeded.
    """
    import scipy.sparse as sp
    from scipy.sparse.linalg import ArpackNoConvergence, eigsh, lobpcg

    k = dims.k
    S = _assemble_S_host(P, C, dims)
    rng = np.random.default_rng(0)

    if eta > 0:
        logging.getLogger(__name__).info(
            "host LDL^T proof of S + eta I: k=%d, nnz=%d", k, S.nnz)
        proof = ldl_psd_proof(S + eta * sp.identity(k, format="csr"))
        if proof is True:
            return True, 0.0, None
        if proof is False:
            # inertia PROVES lambda_min < -eta; bracket it and pull an
            # escape direction by shift-invert inside the bracket
            br = _inertia_bracket_min_eig(S, eta)
            if br is not None:
                lo, hi = br
                sigma = -0.5 * (lo + hi)
                try:
                    _, Vv = eigsh(S, k=1, sigma=sigma, which="LM",
                                  maxiter=1000, v0=rng.standard_normal(k))
                    v = Vv[:, 0]
                    v = v / np.linalg.norm(v)
                    theta = float(v @ (S @ v))
                    if theta + eta < 0:
                        return False, theta, v
                except Exception:  # noqa: BLE001  (ARPACK failure)
                    pass
                return False, -0.5 * (lo + hi), None
            return False, -eta, None

    lam_max = float(eigsh(S, k=1, which="LA", return_eigenvectors=False,
                          tol=1e-4, ncv=min(k, 50),
                          v0=rng.standard_normal(k))[0])
    shift = 1.01 * max(lam_max, 1e-6)
    B = (shift * sp.identity(k, format="csr") - S).tocsr()
    rng = np.random.default_rng(0)
    v, converged = None, False
    for ncv in (min(k, 96), min(k, 256)):
        try:
            _, vecs = eigsh(B, k=1, which="LA", tol=1e-7, ncv=ncv,
                            maxiter=500, v0=rng.standard_normal(k))
            v, converged = vecs[:, 0], True
            break
        except ArpackNoConvergence as e:
            if len(e.eigenvectors) and e.eigenvectors.shape[1]:
                v = e.eigenvectors[:, -1]  # kept only as a candidate
    if not converged:
        Xb = rng.standard_normal((k, min(k, 8)))
        if v is not None:
            Xb[:, 0] = v
        w, Vb = lobpcg(B, Xb, tol=1e-7, maxiter=2000, largest=True)
        v = Vb[:, int(np.argmax(w))]
    v = v / np.linalg.norm(v)
    Sv = S @ v
    theta = float(v @ Sv)
    resid = float(np.linalg.norm(Sv - theta * v))
    if theta + eta < 0:
        return False, theta, v  # sound: theta >= lambda_min
    if resid <= max(1e-8 * max(abs(lam_max), 1.0), 1e-12):
        return theta + eta >= 0, theta, v
    logging.getLogger(__name__).warning(
        "PSD check inconclusive (resid=%.3e, theta=%.3e): failing closed",
        resid, theta)
    return False, theta, v


def fast_verification(P: ProblemData, X: RAState, eta: float,
                      num_lanczos: int = 64, TP=None,
                      generator: Optional[torch.Generator] = None):
    """Check S + eta*I >= 0 (reference: fastVerification,
    DCORA_utils.cpp:1713-1735).

    Returns (is_psd, theta, min_eigenvector [k] tensor) where theta =
    v^T S v for the estimated minimum eigenvector (0, None when certified).
    "Not PSD" is proven by an exact f64 Rayleigh quotient; "PSD" is
    confirmed by the host LDL^T check.  With TP (a tiled.TiledProblem) the
    search first runs on the tiled operator through the SpMM kernel.
    """
    C = dual_certificate_blocks(P, X)
    dims = X.dims
    mv = _flat_matvec(P, C, dims, 0.0)
    if TP is not None:
        _, v_est = minimum_eigen_pair_tiled(TP, X, num_lanczos, generator)
        vj = v_est / torch.linalg.vector_norm(v_est)
        theta = float(torch.dot(vj, mv(vj)))
        if theta + eta < 0:
            return False, theta, vj
    lam_min, v, _ = minimum_eigen_pair(P, C, dims, num_lanczos,
                                       generator=generator)
    if lam_min + eta < 0:
        theta = float(torch.dot(v, mv(v)))
        if theta + eta < 0:
            return False, theta, v
    certified, lam_host, v_host = _min_eig_host(P, C, dims, eta)
    if certified:
        return True, 0.0, None
    if v_host is not None:
        v = torch.as_tensor(v_host, dtype=torch.float64, device=X.device)
    return False, lam_host, v


# --------------------------------------------------------------------------
# Saddle escape (reference: QuadraticProblem.cpp:138-234)
# --------------------------------------------------------------------------


def escape_saddle(P: ProblemData, X_opt: RAState, theta: float,
                  v, r_target: int,
                  gradient_tolerance: float = 1e-6,
                  preconditioned_gradient_tolerance: float = 1e-6,
                  M=None, is_second_order: bool = False
                  ) -> Tuple[bool, Optional[RAState]]:
    """Lift a rank-(r-1) critical point and descend along the min-eig
    direction with a backtracking retraction line search."""
    dims = X_opt.dims
    if r_target != X_opt.r + 1:
        raise ValueError(f"escape_saddle: r_target {r_target} != r + 1")
    X_plus = lifted.pad_rank(X_opt, r_target)
    Vdir = torch.zeros((r_target, dims.k), dtype=X_opt.dtype,
                       device=X_opt.device)
    Vdir[r_target - 1] = torch.as_tensor(v, dtype=X_opt.dtype,
                                         device=X_opt.device)
    X_dot = lifted.from_flat(Vdir, dims)
    G = lifted.zeros(dims, r_target, X_opt.dtype, X_opt.device)

    alpha_min = 1e-6
    # backtrack from alpha >= 1 (see the JAX module: the second-order
    # heuristic step alone can fall below the retraction's constant offset)
    alpha = (max(1.0, 100 * gradient_tolerance / abs(theta))
             if is_second_order else 1.0)

    def trial(a):
        Xtest = retract(X_plus, X_dot.scale(a))
        ftest = prob.cost(P, Xtest, G)
        g = tangent_project(Xtest, prob.euclidean_gradient(P, Xtest, G))
        gnorm = g.norm()
        if M is not None:
            pgnorm = tangent_project(
                Xtest, prob.apply_preconditioner(M, g)).norm()
        else:
            pgnorm = gnorm
        return torch.stack([ftest, gnorm, pgnorm]).tolist()

    # baseline at the RETRACTED lift (retraction shifts f by a constant)
    fX_plus = float(prob.cost(P, retract(X_plus, X_dot.scale(0.0)), G))
    alphas, fvals = [], []
    while alpha >= alpha_min:
        ftest, gnorm, pgnorm = trial(alpha)
        alphas.append(alpha)
        fvals.append(ftest)
        if (ftest < fX_plus and gnorm > gradient_tolerance
                and pgnorm > preconditioned_gradient_tolerance):
            return True, retract(X_plus, X_dot.scale(alpha))
        alpha /= 2
    i_min = int(np.argmin(fvals))
    if fvals[i_min] < fX_plus:
        return True, retract(X_plus, X_dot.scale(alphas[i_min]))
    return False, None


# --------------------------------------------------------------------------
# Solution rounding (reference: projectSolutionRASLAM,
# DCORA_utils.cpp:1984-2031, CORA Alg. 3)
# --------------------------------------------------------------------------


def round_solution(X: RAState) -> RAState:
    """Round a rank-r solution to rank d: thin SVD of X^T, det-majority
    reflection, project rotations to SO(d) and spheres to the sphere."""
    dims = X.dims
    d = dims.d
    U, s, _ = torch.linalg.svd(lifted.to_flat(X).T, full_matrices=False)
    Xd = lifted.from_flat((U[:, :d] * s[:d]).T, dims)
    # reflect if fewer than half of the rotation blocks have positive det
    num_pos = int((torch.linalg.det(Xd.rot) > 0).sum())
    R = torch.eye(d, dtype=X.dtype, device=X.device)
    if num_pos < dims.n / 2.0:
        R[d - 1, d - 1] = -1.0
    return RAState(
        rot=rotation_project(torch.einsum("ij,njc->nic", R, Xd.rot)),
        sph=oblique_project(torch.einsum("ij,lj->li", R, Xd.sph)),
        trn=torch.einsum("ij,tj->ti", R, Xd.trn),
    )
