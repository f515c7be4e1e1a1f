"""Optimality certification: dual certificate, Lanczos min-eig, saddle escape.

Counterpart of ``dcora_tpu.core.certify``.  Replaces the reference's
CHOLMOD PSD check + Spectra eigensolvers (DCORA_utils.cpp:1713-1982) with a
matrix-free Lanczos (full reorthogonalization) over S = Q - Lambda(X),
following the SE-Sync spectrum-shifting strategy (DCORA_utils.cpp:1807-1896):

  1. lambda_lm <- largest-magnitude eigenvalue of S.  If negative, it IS the
     minimum eigenvalue.
  2. Otherwise run Lanczos on S - 2*lambda_lm*I (all eigenvalues negative);
     its largest-magnitude eigenvalue + 2*lambda_lm is lambda_min(S).

A PSD verdict is confirmed by an LDL^T inertia proof of S + eta*I, with
S assembled on the host: where the problem's tensors live on CUDA, a
supernodal LDL^T on the card (``core/ldlt.py``, ``csrc/ldlt.cu``; the
sparsity analysed once on the host); on the CPU, scipy's SuperLU,
unchanged from the JAX package.  Also the saddle-escape line search
(QuadraticProblem.cpp:138-234) and rank-d rounding (DCORA_utils.cpp:
1984-2031).

Lanczos restarts after a breakdown draw from an injected torch.Generator
(the JAX package draws from jax.random, whose stream torch cannot
reproduce); the start vectors are numpy-made and carry over exactly.  On
the card each Lanczos step is one replay of a captured CUDA graph
(LanczosGraph), with the eager loop's bits; on the CPU the loop is eager.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dcora_tpu_torch.core import kernels, ldlt, lifted, problem as prob, tiled
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.manifold import (
    oblique_project,
    retract,
    rotation_project,
    tangent_project,
)
from dcora_tpu_torch.core.problem import ProblemData
from dcora_tpu_torch.types import ProblemDims
from dcora_tpu_torch.utils.timing import count, span


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


def _lanczos_step(mv, v, basis, alphas, betas, j, breakdown: float,
                  generator: torch.Generator):
    """Lanczos step j (0-d, on the device; advanced here) in place, with
    two-pass full reorthogonalization: v is basis row j, then the next
    vector, or after a lucky breakdown (beta below `breakdown`) a fresh
    direction drawn from `generator`, orthogonal to the basis."""
    at = j.view(1)
    basis.index_copy_(0, at, v[None])
    w = mv(v)
    alphas.index_copy_(0, at, torch.dot(v, w)[None])
    for _ in range(2):
        w = w - basis.T @ (basis @ w)
    b = torch.linalg.vector_norm(w)
    betas.index_copy_(0, at, b[None])
    fresh = torch.randn(v.shape[0], generator=generator, dtype=v.dtype,
                        device=v.device)
    for _ in range(2):
        fresh = fresh - basis.T @ (basis @ fresh)
    fresh = fresh / torch.clamp(torch.linalg.vector_norm(fresh),
                                min=1e-300 if v.dtype == torch.float64
                                else 1e-30)
    v.copy_(torch.where(b > breakdown,
                        w / torch.where(b == 0, torch.ones_like(b), b),
                        fresh))
    j.add_(1)


def _lanczos(mv, v0: torch.Tensor, m: int, breakdown: float,
             generator: torch.Generator):
    """m _lanczos_steps issued one by one from v0: (alphas, betas, basis).
    No host sync inside the loop."""
    count("lanczos.steps", m)
    kw = dict(dtype=v0.dtype, device=v0.device)
    basis = torch.zeros((m, v0.shape[0]), **kw)
    alphas, betas = torch.zeros(m, **kw), torch.zeros(m, **kw)
    j = torch.zeros((), dtype=torch.int64, device=v0.device)
    v = v0 / torch.linalg.vector_norm(v0)
    for _ in range(m):
        _lanczos_step(mv, v, basis, alphas, betas, j, breakdown, generator)
    return alphas, betas, basis


class LanczosGraph:
    """One _lanczos_step captured once as a CUDA graph, replayed m times
    a sweep, for every shift of one operator: sweep(v0, shift) is
    _lanczos(make_mv(shift), v0, m, breakdown, generator).

    Issued from Python a step is ~30 small kernels (the matvec, the index
    writes, the two-pass reorthogonalization of w and of the fresh
    direction, the norms), whose host issue time exceeds their device
    time; the step holds no host decision, so it is recorded once.  The
    graph reads static buffers: v, the basis [m, k], alphas and betas [m],
    the step index j (0-d, on the device) and the shift (0-d), which
    make_mv(shift)'s matvec reads.  The restarts draw from `generator`
    (registered with the graph) in the eager loop's order, so a sweep
    gives its bits.  The launches of the port's kernels it records count
    once per replay."""

    def __init__(self, make_mv, v0: torch.Tensor, m: int, breakdown: float,
                 generator: torch.Generator):
        kw = dict(dtype=v0.dtype, device=v0.device)
        self.m, self.breakdown, self.generator = m, breakdown, generator
        self.shift = torch.zeros((), **kw)
        self.mv = make_mv(self.shift)
        self.v = torch.zeros(v0.shape[0], **kw)
        self.basis = torch.zeros((m, v0.shape[0]), **kw)
        self.alphas, self.betas = torch.zeros(m, **kw), torch.zeros(m, **kw)
        self.j = torch.zeros((), dtype=torch.int64, device=v0.device)
        self.graph, self.per_replay = None, {}

    def _step(self):
        _lanczos_step(self.mv, self.v, self.basis, self.alphas, self.betas,
                      self.j, self.breakdown, self.generator)

    def __call__(self, v0: torch.Tensor, shift):
        """(alphas, betas, basis): the graph's own buffers, which the next
        sweep overwrites."""
        count("lanczos.steps", self.m)
        count("lanczos.graph_steps", self.m)
        if self.graph is None:
            count("lanczos.graph_captures")
            self.graph, self.per_replay = kernels.record(
                self._step, self.v.device, self.generator)
        self.shift.fill_(shift)
        self.v.copy_(v0 / torch.linalg.vector_norm(v0))
        self.basis.zero_()
        self.j.zero_()
        for _ in range(self.m):
            self.graph.replay()
            kernels.add_replays(self.per_replay)
        return self.alphas, self.betas, self.basis


def _sweeps(make_mv, v0: torch.Tensor, m: int, breakdown: float,
            generator: torch.Generator):
    """sweep(v, shift) -> _lanczos(make_mv(shift), v, m, breakdown,
    generator) for one operator: on the card by replaying one LanczosGraph,
    captured at the first sweep and shared by every shift; elsewhere
    eagerly."""
    if v0.is_cuda:
        return LanczosGraph(make_mv, v0, m, breakdown, generator)
    return _eager_sweeps(make_mv, v0, m, breakdown, generator)


def _eager_sweeps(make_mv, v0: torch.Tensor, m: int, breakdown: float,
                  generator: torch.Generator):
    return lambda v, shift: _lanczos(make_mv(shift), v, m, breakdown,
                                     generator)


def _ritz_extreme(alphas, betas, basis):
    """Largest-magnitude Ritz pair and its residual bound."""
    Tm = torch.diag(alphas) + torch.diag(betas[:-1], 1) + \
        torch.diag(betas[:-1], -1)
    evals, evecs = torch.linalg.eigh(Tm)
    idx = torch.argmax(evals.abs())
    y = basis.T @ evecs[:, idx]
    resid = (betas[-1] * evecs[-1, idx]).abs()
    return evals[idx], y, resid


def _spectrum_shift(sweep, v0: torch.Tensor, start, rel_tol: float,
                    abs_tol: float, cap: int):
    """(lambda_min, Ritz vector, residual tensor) of S by spectrum shifting
    (module docstring) over Lanczos sweeps sweep(v, shift) of S + shift I:
    where lam_lm is not negative, the lowest of sweeps of S - 2 lam_lm I
    from start(), then each from the last Ritz vector, until two in a row
    gain no more than max(abs_tol, rel_tol |lam_lm|) (one sweep can miss a
    clustered bottom eigenvalue) or `cap` sweeps."""
    lam_lm, y, res = _ritz_extreme(*sweep(v0, 0.0))
    lam_lm_f = float(lam_lm)
    if lam_lm_f < 0:
        return lam_lm_f, y, res
    tol = max(abs_tol, rel_tol * abs(lam_lm_f))
    best, stagnant, v = None, 0, start()
    for _ in range(cap):
        lam_s, y_s, res_s = _ritz_extreme(*sweep(v, -2.0 * lam_lm))
        lam_cur = float(lam_s + 2.0 * lam_lm)
        stagnant = stagnant + 1 if best and lam_cur > best[0] - tol else 0
        if stagnant >= 2:
            break
        if best is None or lam_cur < best[0]:
            best = lam_cur, y_s, res_s
        v = y_s
    return best


def _shifted_start(mv, rng: np.random.Generator, like: torch.Tensor):
    """S's row 0 (mv: v -> S v) perturbed by 0.03 ||row0|| along a draw of
    `rng`, else a draw (reference: DCORA_utils.cpp:1861-1866)."""
    kw = dict(dtype=like.dtype, device=like.device)
    e0 = torch.zeros(like.shape[0], **kw)
    e0[0] = 1.0
    row0 = mv(e0)
    pert = rng.standard_normal(like.shape[0])
    pert /= np.linalg.norm(pert)
    v0s = row0 + 0.03 * torch.linalg.vector_norm(row0) * \
        torch.as_tensor(pert, **kw)
    if float(torch.linalg.vector_norm(v0s)) < 1e-12:
        v0s = torch.as_tensor(rng.standard_normal(like.shape[0]), **kw)
    return v0s


def _min_eig_pair(make_mv, v0: torch.Tensor, num_lanczos: int, generator,
                  rng, sweeps=None):
    """(lambda_min, eigvec, residual) of the f64 S (make_mv(shift): v ->
    (S + shift I) v) by the sweeps of `sweeps` (default _sweeps), the
    shifted start perturbed by draws of `rng`."""
    m = min(num_lanczos, v0.shape[0])
    gen = generator or _default_generator(v0.device)
    sweep = (sweeps or _sweeps)(make_mv, v0, m, 1e-12, gen)
    lam, y, res = _spectrum_shift(
        sweep, v0, lambda: _shifted_start(make_mv(0.0), rng, v0), 1e-9,
        1e-12, 40)
    return lam, y, float(res)


def minimum_eigen_pair(P: ProblemData, C: Certificate, dims: ProblemDims,
                       num_lanczos: int = 64,
                       v0: Optional[np.ndarray] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[float, torch.Tensor, float]:
    """(lambda_min, eigvec [k], residual) of S via spectrum shifting; the
    shifted start's perturbation from numpy's default_rng(1)."""
    if v0 is None:
        v0 = np.random.default_rng(0).standard_normal(dims.k)
    v0 = torch.as_tensor(v0, dtype=torch.float64, device=C.rot_blocks.device)
    return _min_eig_pair(partial(_flat_matvec, P, C, dims), v0, num_lanczos,
                         generator, np.random.default_rng(1))


# --------------------------------------------------------------------------
# Flat tiled Lanczos: the S matvec in the flat basis is apply_tiled minus
# the Weingarten term (flat_rhess without the projection); it runs the SpMM
# kernel at the tile dtype with one live row of an r_pad = 8 operand.
# --------------------------------------------------------------------------


def _tiled_matvec(TP, aux, shift):
    def mv(v):
        V = torch.zeros((8, v.shape[0]), dtype=v.dtype, device=v.device)
        V[0] = v  # rows 1.. stay zero
        W = tiled.flat_rhess(TP.meta, None, tiled.apply_tiled(TP, V), V,
                             aux, project=False)
        return W[0] + shift * v

    return mv


def minimum_eigen_pair_tiled(TP, X: RAState, num_lanczos: int = 64,
                             generator: Optional[torch.Generator] = None):
    """(lambda_min estimate, RA-flat eigenvector [k] in f64) via the tiled
    S operator at the tile dtype; PSD conclusions must be validated at f64
    (see fast_verification)."""
    meta, dt = TP.meta, TP.dtype
    gen = generator or _default_generator(TP.device)
    r_pad = max(8, -(-X.r // 8) * 8)
    Xf = tiled.to_flat(TP, X, r_pad=r_pad).to(dt)
    aux = tiled.weingarten_setup(meta, Xf, tiled.apply_tiled(TP, Xf))

    m = min(num_lanczos, meta.k)
    v0 = np.zeros(meta.kpad)
    v0[:meta.k] = np.random.default_rng(0).standard_normal(meta.k)
    v0 = torch.as_tensor(v0, dtype=dt, device=TP.device)

    sweep = _sweeps(partial(_tiled_matvec, TP, aux), v0, m, 1e-7, gen)
    lam, y, _ = _spectrum_shift(sweep, v0, lambda: v0, 1e-6, 0.0, 20)
    return lam, lifted.to_flat(tiled.from_flat(TP, y[None].double()))[0]


# --------------------------------------------------------------------------
# Exact certification: S assembled on the host (scipy); its LDL^T inertia
# proof on the card for a CUDA problem (core/ldlt.py), else SuperLU on the
# host as in the JAX package; ARPACK / LOBPCG on the host
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


def _host_proof(S):
    """prove(t): SuperLU's LDL^T verdict on S + t*I (ldl_psd_proof)."""
    import scipy.sparse as sp

    eye = sp.identity(S.shape[0], format="csc")
    return lambda t: ldl_psd_proof(S + t * eye)


def _shifted_proof(S, dims: ProblemDims, device, times=None):
    """prove(t) for the shifts of one S in _min_eig_host: on a CUDA device
    the supernodal LDL^T on the card (analysis and upload once), else
    SuperLU (each proof counted "ldlt.host")."""
    if torch.device(device).type == "cuda":
        return ldlt.ShiftedProof(S, dims, device, times)
    superlu = _host_proof(S)

    def prove(t):
        count("ldlt.host")
        return superlu(t)

    return prove


def _inertia_bracket_min_eig(S, eta: float, max_doublings: int = 40,
                             bisections: int = 10,
                             times: Optional[dict] = None, prove=None):
    """Bracket -lambda_min(S) with the LDL^T inertia oracle, given that
    S + eta*I is proven indefinite: double t until S + t*I factors PD, then
    bisect.  Returns (lo, hi) or None.  `prove(t)` is the oracle's verdict
    on S + t*I (default: SuperLU on the host); each call is a span
    "certify/ldlt" into `times`."""
    prove = prove or _host_proof(S)
    lo, hi = eta, None
    t = max(2.0 * eta, 1e-10)
    for _ in range(max_doublings):
        with span("certify/ldlt", into=times):
            pr = prove(t)
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
        with span("certify/ldlt", into=times):
            pr = prove(mid)
        if pr is True:
            hi = mid
        elif pr is False:
            lo = mid
        else:
            break
    return lo, hi


def _min_eig_host(P: ProblemData, C: Certificate, dims: ProblemDims,
                  eta: float = 0.0, times: Optional[dict] = None
                  ) -> Tuple[bool, float, Optional[np.ndarray]]:
    """Fail-closed host check of lambda_min(S) >= -eta.

    Returns (certified, rayleigh, v):
      1. LDL^T proof of S + eta*I (an actual factorization witness): on the
         card when P's tensors live on CUDA (core/ldlt.py: one analysis
         for every shift of this call), else SuperLU;
      2. otherwise ARPACK on shift*I - S with an explicit residual check,
         LOBPCG fallback;
      3. fail closed: never certify from an unconverged vector.
    A negative Rayleigh quotient below -eta is a sound indefiniteness proof.

    Every ARPACK call starts from a vector of a seeded generator: without
    one ARPACK draws its start from a stream it keeps across calls in the
    process, so the same S gives another estimate (in its last digits) on
    every call.  The JAX package leaves two of the calls unseeded.

    The assembly, each LDL^T proof (the card's: analysis, upload,
    factorization and read-back) and the eigensolvers are spans
    "certify/assemble", "certify/ldlt" and "certify/host_eig" into `times`;
    the analysis is also "certify/ldlt_analyse".
    """
    import scipy.sparse as sp
    from scipy.sparse.linalg import ArpackNoConvergence, eigsh, lobpcg

    k = dims.k
    with span("certify/assemble", into=times):
        S = _assemble_S_host(P, C, dims)
    rng = np.random.default_rng(0)

    if eta > 0:
        logging.getLogger(__name__).info(
            "LDL^T proof of S + eta I: k=%d, nnz=%d", k, S.nnz)
        prove = _shifted_proof(S, dims, C.rot_blocks.device, times)
        with span("certify/ldlt", into=times):
            proof = prove(eta)
        if proof is True:
            return True, 0.0, None
        if proof is False:
            # inertia PROVES lambda_min < -eta; bracket it and pull an
            # escape direction by shift-invert inside the bracket
            br = _inertia_bracket_min_eig(S, eta, times=times, prove=prove)
            if br is not None:
                lo, hi = br
                sigma = -0.5 * (lo + hi)
                with span("certify/host_eig", into=times):
                    try:
                        _, Vv = eigsh(S, k=1, sigma=sigma, which="LM",
                                      maxiter=1000,
                                      v0=rng.standard_normal(k))
                        proof = _rayleigh_proof(
                            lambda u: S @ u,
                            Vv[:, 0] / np.linalg.norm(Vv[:, 0]), eta)
                        if proof:
                            return proof
                    except Exception:  # noqa: BLE001  (ARPACK failure)
                        pass
                return False, sigma, None
            return False, -eta, None

    with span("certify/host_eig", into=times):
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


def _rayleigh_proof(mv, v, eta: float):
    """The verdict (False, theta, v) where theta = v^T S v (>= lambda_min;
    mv: v -> S v, on tensors or on the host's arrays) is below -eta, a
    sound proof that S + eta*I is not PSD; else None."""
    theta = float(v @ mv(v))
    return (False, theta, v) if theta + eta < 0 else None


def _host_verdict(P: ProblemData, C: Certificate, dims: ProblemDims,
                  eta: float, v: torch.Tensor, times: Optional[dict] = None):
    """(is_psd, theta, vector) of _min_eig_host; v where it has none."""
    certified, lam_host, v_host = _min_eig_host(P, C, dims, eta,
                                                times=times)
    if certified:
        return True, 0.0, None
    if v_host is not None:
        v = torch.as_tensor(v_host, dtype=torch.float64, device=v.device)
    return False, lam_host, v


def fast_verification(P: ProblemData, X: RAState, eta: float,
                      num_lanczos: int = 64, TP=None,
                      generator: Optional[torch.Generator] = None,
                      times: Optional[dict] = None):
    """Check S + eta*I >= 0 (reference: fastVerification,
    DCORA_utils.cpp:1713-1735).

    Returns (is_psd, theta, min_eigenvector [k] tensor) where theta =
    v^T S v for the estimated minimum eigenvector (0, None when certified).
    "Not PSD" is proven by an exact f64 Rayleigh quotient; "PSD" is
    confirmed by the LDL^T check (_min_eig_host).  With TP (a
    tiled.TiledProblem) the search first runs on the tiled operator through
    the SpMM kernel.
    Its steps are spans "certify/<part>" (blocks, lanczos, assemble, ldlt,
    host_eig) into `times`.
    """
    count("certify.calls")
    with span("certify/blocks", into=times):
        C = dual_certificate_blocks(P, X)
    dims = X.dims
    mv = _flat_matvec(P, C, dims, 0.0)
    if TP is not None:
        with span("certify/lanczos", into=times):
            _, v = minimum_eigen_pair_tiled(TP, X, num_lanczos, generator)
            proof = _rayleigh_proof(mv, v / torch.linalg.vector_norm(v), eta)
        if proof:
            return proof
    with span("certify/lanczos", into=times):
        lam_min, v, _ = minimum_eigen_pair(P, C, dims, num_lanczos,
                                           generator=generator)
        proof = lam_min + eta < 0 and _rayleigh_proof(mv, v, eta)
    return proof or _host_verdict(P, C, dims, eta, v, times)


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
