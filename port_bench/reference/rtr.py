"""A plain Riemannian trust-region solve of the reference problem.

The method the port implements (ROPTLIB's RTRNewton as the reference
configures it: Steihaug-Toint truncated CG with the kappa/theta stopping
rule, radius 100 growing to 5x, rho regularized near convergence), written
out plainly over the reference's flat state: the Weingarten-corrected
Hessian P_X(Q eta - W(eta)), a per-pose block-Jacobi preconditioner of Q
(each pose's (d+1) x (d+1) block plus reg I, the diagonal of spheres and
landmarks, reg by CORA's rule), the polar retraction on the Stiefel
blocks and normalization of the spheres.  No CUDA graph, no masking, no
kernel of the port.

``lower`` rounds every vector the solve stores (products, iterates, tCG
vectors) to a lower precision: the control of the benchmark's comparison
runs this solve in float32 or with bfloat16 storage in the program's
place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from port_bench.reference.problem import Problem


@dataclasses.dataclass(frozen=True)
class Budget:
    max_outer: int
    max_inner: int
    gradnorm_tol: float = 1e-30
    initial_radius: float = 100.0
    max_radius_factor: float = 5.0
    kappa: float = 0.1
    theta: float = 1.0
    rho_accept: float = 0.1
    rho_regularization: float = 1e3


def _identity(x):
    return x


def round_to(dtype: Optional[torch.dtype]) -> Callable:
    """x rounded to dtype and back (None: unchanged)."""
    if dtype is None:
        return _identity
    return lambda x: x.to(dtype).to(x.dtype)


def regularization(g, Q) -> float:
    """The reference's rule (CORA, Graph.cpp:1901-1960): 0.1 for a pose
    graph, lambda_max(Q) / (1e6 - 1) for a range-aided problem, with
    lambda_max estimated as the JAX package and the port estimate it: 50
    power iterations from the all-ones vector."""
    if g.is_pgo:
        return 0.1
    v = np.ones(Q.shape[0]) / np.sqrt(Q.shape[0])
    lam = 0.0
    for _ in range(50):
        w = Q @ v
        lam = float(np.linalg.norm(w))
        v = w / (lam if lam else 1.0)
    return lam / (1e6 - 1.0)


class Jacobi:
    """Inverse per-pose blocks of Q (+ reg I) and inverse diagonals."""

    def __init__(self, P: Problem):
        g = P.g
        d, n = g.d, g.n
        Q = (P.A_host.T @ P.A_host).tocsr()
        reg = regularization(g, Q)
        idx = np.concatenate([np.arange(n)[:, None] * d + np.arange(d),
                              (d * n + g.l + np.arange(n))[:, None]], 1)
        pose_of = np.full(g.k, -1)
        local = np.zeros(g.k, dtype=np.int64)
        pose_of[idx] = np.arange(n)[:, None]
        local[idx] = np.arange(d + 1)[None, :]
        C = Q.tocoo()
        keep = (pose_of[C.row] >= 0) & (pose_of[C.row] == pose_of[C.col])
        blocks = np.zeros((n, d + 1, d + 1))
        np.add.at(blocks, (pose_of[C.row[keep]], local[C.row[keep]],
                           local[C.col[keep]]), C.data[keep])
        inv = np.linalg.inv(blocks + reg * np.eye(d + 1))
        diag = Q.diagonal()
        rest = np.concatenate([d * n + np.arange(g.l),
                               d * n + g.l + n + np.arange(g.b)])
        kw = dict(dtype=P.dtype, device=P.device)
        self.idx = torch.as_tensor(idx, device=P.device)
        self.inv = torch.as_tensor(inv, **kw)
        self.rest = torch.as_tensor(rest, device=P.device)
        self.rest_inv = torch.as_tensor(1.0 / (diag[rest] + reg), **kw)

    def __call__(self, V: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(V)
        blk = V[:, self.idx]  # [r, n, d+1]
        out[:, self.idx] = torch.einsum("rnc,nce->rne", blk, self.inv)
        out[:, self.rest] = V[:, self.rest] * self.rest_inv
        return out


class Solver:
    def __init__(self, P: Problem, budget: Budget,
                 lower: Callable = _identity):
        self.P, self.cfg, self.lo = P, budget, lower
        self.M = Jacobi(P)

    # -- pieces -------------------------------------------------------------
    def egrad(self, X):
        return self.lo(self.P.QX(X))

    def weingarten(self, X, G, eta):
        P = self.P
        Y, Gr = P.rot(X), P.rot(G)
        S = torch.einsum("rna,rnb->nab", Y, Gr)
        S = 0.5 * (S + S.transpose(1, 2))
        W = torch.zeros_like(eta)
        P.rot(W)[:] = torch.einsum("rna,nab->rnb", P.rot(eta), S)
        if P.g.l:
            P.sph(W)[:] = P.sph(eta) * (P.sph(X) * P.sph(G)).sum(
                0, keepdim=True)
        return W

    def hess(self, X, G, eta):
        return self.lo(self.P.tangent(X, self.egrad(eta)
                                      - self.weingarten(X, G, eta)))

    def precond(self, X, V):
        return self.lo(self.P.tangent(X, self.M(V)))

    def retract(self, X, V):
        P = self.P
        out = X + V
        A = P.rot(out)
        Gm = torch.einsum("rna,rnb->nab", A, A)
        w, U = torch.linalg.eigh(Gm)
        inv_sqrt = torch.einsum("nab,nb,ncb->nac", U, w.rsqrt(), U)
        P.rot(out)[:] = torch.einsum("rna,nab->rnb", A, inv_sqrt)
        if P.g.l:
            s = P.sph(out)
            P.sph(out)[:] = s / torch.linalg.vector_norm(s, dim=0,
                                                         keepdim=True)
        return self.lo(out)

    def f(self, X, W):
        return 0.5 * torch.sum(W * X)

    # -- truncated CG -------------------------------------------------------
    def tcg(self, X, G, grad, radius):
        cfg = self.cfg
        eta = torch.zeros_like(grad)
        Heta = torch.zeros_like(grad)
        r = grad
        z = self.precond(X, r)
        d = -z
        rz = torch.sum(r * z)
        r0 = torch.linalg.vector_norm(r)
        stop = r0 * min(float(r0) ** cfg.theta, cfg.kappa)
        for _ in range(cfg.max_inner):
            Hd = self.hess(X, G, d)
            dHd = torch.sum(d * Hd)
            alpha = rz / dHd if float(dHd) != 0 else rz
            eta_next = self.lo(eta + alpha * d)
            if float(dHd) <= 0 or \
                    float(torch.linalg.vector_norm(eta_next)) >= radius:
                dd, ed, ee = (torch.sum(d * d), torch.sum(eta * d),
                              torch.sum(eta * eta))
                disc = torch.clamp(ed * ed - dd * (ee - radius ** 2), min=0)
                tau = (-ed + torch.sqrt(disc)) / dd
                return self.lo(eta + tau * d), self.lo(Heta + tau * Hd)
            eta, Heta = eta_next, self.lo(Heta + alpha * Hd)
            r = self.lo(r + alpha * Hd)
            if float(torch.linalg.vector_norm(r)) <= float(stop):
                break
            z = self.precond(X, r)
            rz_new = torch.sum(r * z)
            d = self.lo(-z + (rz_new / rz) * d)
            rz = rz_new
        return eta, Heta

    # -- trust region -------------------------------------------------------
    def solve(self, X0: torch.Tensor):
        """(X, f, gradnorm, outer iterations) after the budget."""
        cfg = self.cfg
        eps = torch.finfo(X0.dtype).eps
        radius = cfg.initial_radius
        max_radius = radius * cfg.max_radius_factor
        X = self.lo(X0.clone())
        W = self.egrad(X)
        gn = float(torch.linalg.vector_norm(self.P.tangent(X, W)))
        it = 0
        while it < cfg.max_outer and gn >= cfg.gradnorm_tol:
            fX = self.f(X, W)
            grad = self.lo(self.P.tangent(X, W))
            eta, Heta = self.tcg(X, W, grad, radius)
            Xt = self.retract(X, eta)
            Wt = self.egrad(Xt)
            ft = self.f(Xt, Wt)
            model = -(torch.sum(grad * eta) + 0.5 * torch.sum(eta * Heta))
            reg = cfg.rho_regularization * eps * max(float(fX.abs()), 1.0)
            den = float(model) + reg
            rho = (float(fX - ft) + reg) / (den if abs(den) >= 1e-300
                                            else 1e-300)
            accept = rho > cfg.rho_accept and float(ft) <= float(fX) + reg
            hit = float(torch.linalg.vector_norm(eta)) >= 0.99 * radius
            if accept:
                X, W = Xt, Wt
            if rho < 0.25:
                radius /= 4.0
            elif hit and rho > 0.75:
                radius = min(2.0 * radius, max_radius)
            gn = float(torch.linalg.vector_norm(self.P.tangent(X, W)))
            it += 1
        return X, float(self.f(X, W)), gn, it
