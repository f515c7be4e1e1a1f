"""The plain reference's cost, gradients, tangent spaces and certificate.

The lifted state is a flat [r, k] tensor over the columns

    [ Y_1 .. Y_n (d each) | s_1 .. s_l | t_1 .. t_n | L_1 .. L_b ].

Every measurement is a residual that is linear in one row of the state, so
the whole problem is one sparse matrix A (a row per residual scalar, each
row scaled by the square root of its weight) and

    f(X) = 1/2 || A X^T ||^2,      grad f(X) = (A^T A X^T)^T = X Q.

The cost is taken in that residual form, with no cancellation.  Rows of A:

    pose-pose (i, j, R, t):  d rows  sqrt(kappa) (Y_j - Y_i R)[:, c]
                             1 row   sqrt(tau) (Y_i t + t_i - t_j)
    pose-landmark (i, k, t): 1 row   sqrt(tau) (Y_i t + t_i - L_k)
    range (a, b, q, rho):    1 row   sqrt(prec) (rho s_q + t_b - t_a)

Imports numpy, scipy and torch only.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from port_bench.reference.graph import Graph


def design_matrix(g: Graph) -> sp.csr_matrix:
    """A as a scipy CSR matrix [residual scalars, k], float64."""
    d, n, l = g.d, g.n, g.l  # noqa: E741
    rot = lambda i, a: i * d + a  # noqa: E731
    sph0 = d * n
    trn0 = d * n + l
    rows, cols, vals = [], [], []
    row = 0
    m = len(g.pp_i)
    if m:
        sk = np.sqrt(g.pp_kappa)
        st = np.sqrt(g.pp_tau)
        for c in range(d):
            r_ = row + np.arange(m)
            rows.append(r_)
            cols.append(rot(g.pp_j, c))
            vals.append(sk)
            for a in range(d):
                rows.append(r_)
                cols.append(rot(g.pp_i, a))
                vals.append(-sk * g.pp_R[:, a, c])
            row += m
        r_ = row + np.arange(m)
        for a in range(d):
            rows.append(r_)
            cols.append(rot(g.pp_i, a))
            vals.append(st * g.pp_t[:, a])
        rows += [r_, r_]
        cols += [trn0 + g.pp_i, trn0 + g.pp_j]
        vals += [st, -st]
        row += m
    m = len(g.pl_i)
    if m:
        st = np.sqrt(g.pl_tau)
        r_ = row + np.arange(m)
        for a in range(d):
            rows.append(r_)
            cols.append(rot(g.pl_i, a))
            vals.append(st * g.pl_t[:, a])
        rows += [r_, r_]
        cols += [trn0 + g.pl_i, trn0 + g.n + g.pl_k]
        vals += [st, -st]
        row += m
    m = len(g.rg_a)
    if m:
        so = np.sqrt(g.rg_prec)
        r_ = row + np.arange(m)
        rows += [r_, r_, r_]
        cols += [sph0 + g.rg_q, trn0 + g.rg_b, trn0 + g.rg_a]
        vals += [so * g.rg_rho, so, -so]
        row += m
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(row, g.k))


def _torch_csr(M: sp.csr_matrix, dtype, device) -> torch.Tensor:
    M = M.tocsr()
    M.sort_indices()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        return torch.sparse_csr_tensor(
            torch.as_tensor(M.indptr, dtype=torch.int64),
            torch.as_tensor(M.indices, dtype=torch.int64),
            torch.as_tensor(M.data, dtype=torch.float64), size=M.shape,
            check_invariants=False).to(dtype=dtype, device=device)


class Problem:
    """The reference problem of a Graph on a device, at a working dtype."""

    def __init__(self, g: Graph, device="cpu", dtype=torch.float64):
        self.g = g
        self.device = torch.device(device)
        self.dtype = dtype
        self.A_host = design_matrix(g)
        self.A = _torch_csr(self.A_host, dtype, self.device)
        self.A_abs = _torch_csr(abs(self.A_host), dtype, self.device)
        self.At = _torch_csr(self.A_host.T.tocsr(), dtype, self.device)

    # -- state layout -----------------------------------------------------
    def flat(self, rot, sph, trn) -> torch.Tensor:
        """[r, k] from rot [n, r, d], sph [l, r], trn [n+b, r]."""
        r = rot.shape[1]
        return torch.cat([rot.permute(1, 0, 2).reshape(r, -1), sph.T, trn.T],
                         dim=1).to(device=self.device, dtype=self.dtype)

    def rot(self, X: torch.Tensor) -> torch.Tensor:
        """[r, n, d] view of the rotation columns."""
        g = self.g
        return X[:, :g.d * g.n].reshape(X.shape[0], g.n, g.d)

    def sph(self, X: torch.Tensor) -> torch.Tensor:
        g = self.g
        return X[:, g.d * g.n:g.d * g.n + g.l]

    def state(self, X: torch.Tensor):
        """(rot [n, r, d], sph [l, r], trn [n+b, r]) of a flat state."""
        g = self.g
        return (self.rot(X).permute(1, 0, 2).contiguous(),
                self.sph(X).T.contiguous(),
                X[:, g.d * g.n + g.l:].T.contiguous())

    # -- cost and gradients -------------------------------------------------
    def residuals(self, X: torch.Tensor) -> torch.Tensor:
        return torch.sparse.mm(self.A, X.T.contiguous())

    def cost(self, X: torch.Tensor) -> float:
        e = self.residuals(X)
        return float(0.5 * torch.sum(e * e))

    def magnitude(self, X: torch.Tensor) -> float:
        """1/2 || |A| |X|^T ||^2: the cost with every term taken by its
        absolute value, the size of the sums any way of forming f adds
        up (0.5 <X, XQ> in particular), so that an error in f divided by
        it is an error in units of the arithmetic's precision."""
        e = torch.sparse.mm(self.A_abs, X.abs().T.contiguous())
        return float(0.5 * torch.sum(e * e))

    def QX(self, X: torch.Tensor) -> torch.Tensor:
        """X Q, [r, k]."""
        return torch.sparse.mm(self.At, self.residuals(X)).T

    def tangent(self, X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """Projection onto the tangent space at X: V - Y sym(Y^T V) on the
        Stiefel blocks, v - s <s, v> on the spheres, V on translations."""
        out = V.clone()
        Y, Vr = self.rot(X), self.rot(V)
        S = torch.einsum("rna,rnb->nab", Y, Vr)
        S = 0.5 * (S + S.transpose(1, 2))
        self.rot(out)[:] = Vr - torch.einsum("rna,nab->rnb", Y, S)
        if self.g.l:
            s, v = self.sph(X), self.sph(V)
            self.sph(out)[:] = v - s * (s * v).sum(0, keepdim=True)
        return out

    def rgrad(self, X: torch.Tensor) -> torch.Tensor:
        return self.tangent(X, self.QX(X))

    def gradnorm(self, X: torch.Tensor) -> float:
        return float(torch.linalg.vector_norm(self.rgrad(X)))

    def manifold_err(self, X: torch.Tensor) -> float:
        """max |Y_i^T Y_i - I| and max | ||s_q|| - 1 |; at rank d also 1
        when any rotation has a negative determinant."""
        Y = self.rot(X)
        G = torch.einsum("rna,rnb->nab", Y, Y)
        eye = torch.eye(self.g.d, dtype=X.dtype, device=X.device)
        err = float((G - eye).abs().max())
        if self.g.l:
            err = max(err, float((torch.linalg.vector_norm(
                self.sph(X), dim=0) - 1).abs().max()))
        if Y.shape[0] == self.g.d and bool(
                (torch.linalg.det(Y.permute(1, 0, 2)) <= 0).any()):
            err = max(err, 1.0)
        return err


def certificate_psd(g: Graph, X: np.ndarray, eta: float) -> Optional[bool]:
    """Whether S + eta I is positive definite, for the dual certificate
    S = Q - Lambda(X) at the lifted state X [r, k] (float64, host):
    Lambda holds sym(Y_i^T (XQ)_i) on the rotation blocks and <s_q, (XQ)_q>
    on the spheres.  The proof is a symmetric LDL^T (SuperLU with diagonal
    pivots only and one symmetric ordering): by Sylvester's law the signs
    of D are the inertia.  True: every pivot positive; False: a negative
    pivot; None: the factorization pivoted off the diagonal or failed, so
    it proves nothing."""
    from scipy.sparse.linalg import splu

    A = design_matrix(g)
    Q = (A.T @ A).tocsr()
    W = np.asarray(Q @ X.T).T  # [r, k]
    d, n, l = g.d, g.n, g.l  # noqa: E741
    r = X.shape[0]
    Y = X[:, :d * n].reshape(r, n, d)
    WY = W[:, :d * n].reshape(r, n, d)
    lam = np.einsum("rna,rnb->nab", Y, WY)
    lam = 0.5 * (lam + lam.transpose(0, 2, 1))
    base = np.arange(n)[:, None, None] * d
    rows = np.broadcast_to(base + np.arange(d)[None, :, None], (n, d, d))
    cols = np.broadcast_to(base + np.arange(d)[None, None, :], (n, d, d))
    sq = d * n + np.arange(l)
    lam_s = (X[:, d * n:d * n + l] * W[:, d * n:d * n + l]).sum(0)
    Lam = sp.coo_matrix(
        (np.concatenate([lam.ravel(), lam_s]),
         (np.concatenate([rows.ravel(), sq]),
          np.concatenate([cols.ravel(), sq]))), shape=Q.shape)
    S = (Q - Lam + eta * sp.identity(g.k)).tocsc()
    try:
        lu = splu(S, diag_pivot_thresh=0.0, permc_spec="MMD_AT_PLUS_A",
                  options=dict(SymmetricMode=True))
    except (RuntimeError, ValueError, MemoryError):
        return None
    if not np.array_equal(lu.perm_r, lu.perm_c):
        return None
    diag = lu.U.diagonal()
    if float(diag.min()) > 0.0:
        return True
    return False
