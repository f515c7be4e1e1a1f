"""A plain synchronous block-Jacobi RBCD of a pose graph's reference
problem: the poses cut into contiguous slices, one per agent, and in every
round each agent's block takes one accepted trust-region step against its
neighbours as they stood at the round's start.

Written from the definition over the reference's flat state (problem.py):
agent a owns the columns C_a of its poses' rotations and translations, and
with the others fixed its block cost is

    f_a(Y) = 1/2 <Q_aa, Y^T Y> + <Y, G_a>,   G_a = X_{-a} Q_{-a,a},

f with the block replaced by Y, less a constant.  Q_aa = A_a^T A_a, A_a the
design matrix's columns C_a (the rows that touch them), so the block is a
Problem of its own; G_a is (X with C_a zeroed) Q, read at C_a.  The step is
rtr.Solver's machinery on that block (per-pose Jacobi, the same tCG and
acceptance test) in the one-accepted-step mode: a block below the gradient
tolerance keeps its state; otherwise tries from the initial radius, each
rejected one quartering it, up to max_rejections + 1 tries.  No stacking,
no padding, no exchange buffers, no kernel of the port.

``lower`` rounds every vector a block's solve stores, as rtr.Solver's does:
computed so in the program's place, the round is the comparison's control.
Pose graphs only (no spheres or landmarks).  Imports numpy, scipy and
torch.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, List, Tuple

import numpy as np
import torch

from port_bench.reference.problem import Problem, _torch_csr
from port_bench.reference.rtr import Budget, Solver, _identity


def partition(n: int, agents: int) -> List[Tuple[int, int]]:
    """(first pose, pose count) of each agent: n // agents contiguous
    poses each, the last agent also the remainder."""
    per = n // agents
    if per < 1:
        raise ValueError(f"{agents} agents for {n} poses")
    return [(a * per, n - a * per if a == agents - 1 else per)
            for a in range(agents)]


class BlockProblem(Problem):
    """Agent a's block of a pose graph's Problem P: the state [r, (d + 1)
    count] over its poses' rotation columns, then their translations."""

    def __init__(self, P: Problem, first: int, count: int):
        g = P.g
        if not g.is_pgo:
            raise ValueError("the reference RBCD takes a pose graph")
        d, n = g.d, g.n
        cols = np.concatenate([np.arange(first * d, (first + count) * d),
                               d * n + np.arange(first, first + count)])
        A = P.A_host[:, cols].tocsr()
        A = A[np.flatnonzero(np.diff(A.indptr))].tocsr()
        self.g = SimpleNamespace(d=d, n=count, l=0, b=0, k=(d + 1) * count,
                                 is_pgo=True)
        self.device, self.dtype = P.device, P.dtype
        self.A_host = A
        self.A = _torch_csr(A, P.dtype, P.device)
        self.A_abs = _torch_csr(abs(A), P.dtype, P.device)
        self.At = _torch_csr(A.T.tocsr(), P.dtype, P.device)
        self.cols = torch.as_tensor(cols, device=P.device)


class BlockSolver(Solver):
    """rtr.Solver on a block with the linear term G (set before each
    step): egrad Y Q_aa + G, the Hessian's product eta Q_aa alone."""

    G: torch.Tensor

    def egrad(self, X):
        return self.lo(self.P.QX(X) + self.G)

    def hess(self, X, G, eta):
        return self.lo(self.P.tangent(X, self.lo(self.P.QX(eta))
                                      - self.weingarten(X, G, eta)))

    def f(self, X, W):
        # W = X Q_aa + G: 1/2 <X Q_aa, X> + <X, G>
        return 0.5 * torch.sum((W + self.G) * X)

    def gradnorm(self, X) -> float:
        return float(torch.linalg.vector_norm(
            self.P.tangent(X, self.egrad(X))))

    def accepted_step(self, X0: torch.Tensor, max_rejections: int):
        """(the block's state after one accepted step, tries made)."""
        cfg = self.cfg
        eps = torch.finfo(X0.dtype).eps
        X = self.lo(X0.clone())
        W = self.egrad(X)
        if float(torch.linalg.vector_norm(self.P.tangent(X, W))) \
                < cfg.gradnorm_tol:
            return X, 0
        radius = cfg.initial_radius
        for tries in range(1, max_rejections + 2):
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
            radius /= 4.0
            if rho > cfg.rho_accept and float(ft) <= float(fX) + reg:
                return Xt, tries
        return X, max_rejections + 1


class Fleet:
    """The agents' blocks of P and the synchronous round over them."""

    def __init__(self, P: Problem, agents: int, budget: Budget,
                 max_rejections: int, lower: Callable = _identity):
        self.P, self.max_rejections, self.lo = P, max_rejections, lower
        self.parts = partition(P.g.n, agents)
        self.blocks = [BlockProblem(P, f, c) for f, c in self.parts]
        self.solvers = [BlockSolver(b, budget, lower) for b in self.blocks]

    def linear_term(self, X: torch.Tensor, a: int) -> torch.Tensor:
        """G_a = X_{-a} Q_{-a,a}: (X with agent a's columns zeroed) Q,
        read at them."""
        cols = self.blocks[a].cols
        Xm = X.clone()
        Xm[:, cols] = 0
        return self.P.QX(Xm)[:, cols]

    def round(self, X: torch.Tensor) -> torch.Tensor:
        """Every block's accepted step against the round's start X."""
        out = X.clone()
        for a, (blk, sol) in enumerate(zip(self.blocks, self.solvers)):
            sol.G = self.lo(self.linear_term(X, a))
            out[:, blk.cols], _ = sol.accepted_step(X[:, blk.cols],
                                                    self.max_rejections)
        return out

    def block_cost(self, X: torch.Tensor, a: int, Y: torch.Tensor) -> float:
        """f with agent a's block of X replaced by Y: f_a(Y) plus a
        constant of X_{-a}, in residual form."""
        Z = X.clone()
        Z[:, self.blocks[a].cols] = Y
        return self.P.cost(Z)

    def block_rise(self, X0: torch.Tensor, X1: torch.Tensor) -> float:
        """The largest rise of an agent's block cost over the round from
        X0 to X1, each block against X0's neighbours, over the magnitude
        of f at X0 (Problem.magnitude); 0 when none rises."""
        f0 = self.P.cost(X0)
        rise = max(self.block_cost(X0, a, X1[:, b.cols]) - f0
                   for a, b in enumerate(self.blocks))
        return max(0.0, rise) / self.P.magnitude(X0)

    def block_gradnorm(self, X0: torch.Tensor, X1: torch.Tensor,
                       a: int) -> float:
        """Agent a's block gradient norm at X1 against X0's neighbours."""
        sol = self.solvers[a]
        sol.G = self.linear_term(X0, a)
        return sol.gradnorm(X1[:, self.blocks[a].cols])
