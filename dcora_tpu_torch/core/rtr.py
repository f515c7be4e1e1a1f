"""Riemannian trust-region solver with truncated CG, in PyTorch.

Counterpart of ``dcora_tpu.core.rtr``: ROPTLIB's RTRNewton as configured by
the reference (QuadraticOptimizer.cpp:234-289) -- GRAD_F stopping on the
Riemannian gradient norm, Steihaug-Toint truncated CG with preconditioning,
initial radius 100 / max radius 5x.

The solver is generic over the state representation through a *backend*:

  * ``RA_BACKEND``   -- RAState + the edge-path cost engine (problem.py);
    exact residual-form numerics.
  * ``FLAT_BACKEND`` -- flat [r_pad, kpad] tensors over the RCM-tiled
    scalar ordering (tiled.py); every Q product goes through the SpMM
    kernel.

The Riemannian Hessian uses the Weingarten-corrected form for embedded
Stiefel/oblique submanifolds,

    Hess f(X)[eta] = P_T( Q eta - W(eta, egrad) ),
    W_rot_i = eta_i sym(Y_i^T egrad_i),   W_sph_q = eta_q <s_q, egrad_q>.

The JAX ``lax.while_loop``s become Python loops.  The tCG inner loop never
waits for the device: its state updates are masked once it has converged,
and the host learns of convergence through a non-blocking probe
(:class:`_DoneProbe`), so it stops issuing iterations a few steps late at
most, and those steps change nothing.  On the card the edge path's
iterations replay a CUDA graph (:class:`TCGGraph`).  The outer loop reads
one flag per iteration.

The one-accepted-step mode of RBCD (``RTRConfig.single_accepted_step``;
QuadraticOptimizer.cpp:253-273) shrinks the radius by 4 after each try, up
to ``max_rejections`` + 1 tries, as a host loop around the same tCG;
``rtr_stacked`` runs it for every agent of a stack at once (the parallel
RBCD of ``dcora_tpu_torch.parallel.rbcd``), with one radius, try count
and tCG stopping state per agent; ``rgd_step`` is the agents' RGD
alternative.  Not ported: ``rtr_chunked``
(a TPU RPC-watchdog workaround), RSD (no agent's ``ROptMethod`` reaches
it) and ``RTRConfig.tcg_f32``, the float32 tCG option (no driver, tool or
config field of either package sets it).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from dcora_tpu_torch.core import kernels
from dcora_tpu_torch.core import problem as prob
from dcora_tpu_torch.core import tiled
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.manifold import retract, tangent_project


# --------------------------------------------------------------------------
# algebra over RAState and bare tensors alike
# --------------------------------------------------------------------------


def _leaves(a):
    return tuple(a) if isinstance(a, RAState) else (a,)


def _rebuild(a, leaves):
    return RAState(*leaves) if isinstance(a, RAState) else leaves[0]


def tmap(fn, *args):
    return _rebuild(args[0], [fn(*xs) for xs in zip(*map(_leaves, args))])


# A stack of agents (parallel.rbcd) carries one solve per agent along an
# agent axis `ax` of every leaf: inner products and norms are then [A]
# tensors, and an [A] factor or flag acts along that axis.  ax=None is the
# single problem, where they are 0-d.


def _along(s, x, ax):
    """s as a factor of leaf x: as it is, or an [A] tensor along axis ax."""
    if ax is None or not isinstance(s, torch.Tensor) or s.dim() == 0:
        return s
    shape = [1] * x.dim()
    shape[ax] = s.shape[0]
    return s.view(shape)


def tvdot(a, b, ax=None) -> torch.Tensor:
    if ax is None:
        return sum(torch.sum(x * y) for x, y in zip(_leaves(a), _leaves(b)))
    return sum((x * y).sum([i for i in range(x.dim()) if i != ax])
               for x, y in zip(_leaves(a), _leaves(b)))


def tnorm(a, ax=None) -> torch.Tensor:
    return torch.sqrt(tvdot(a, a, ax))


def tscale(a, s, ax=None):
    return tmap(lambda x: _along(s, x, ax) * x, a)


def tadd(a, b):
    return tmap(torch.add, a, b)


def taxpy(s, x, y, ax=None):
    """y + s * x."""
    return tmap(lambda xi, yi: yi + _along(s, xi, ax) * xi, x, y)


def twhere(c, a, b, ax=None):
    return tmap(lambda ai, bi: torch.where(_along(c, ai, ax), ai, bi), a, b)


@dataclasses.dataclass(frozen=True)
class RTRConfig:
    gradnorm_tol: float = 1e-2
    max_outer: int = 3
    max_inner: int = 50
    initial_radius: float = 100.0
    max_radius_factor: float = 5.0
    # tCG kappa/theta stopping rule
    kappa: float = 0.1
    theta: float = 1.0
    rho_accept: float = 0.1
    # Manopt-style rho regularization: near convergence f(X) - f(X+) is
    # dominated by eps*|f| cancellation noise; adding
    # reg = rho_regularization*eps*max(1,|f|) to numerator and denominator
    # drives rho -> 1 for noise-level steps.
    rho_regularization: float = 1e3
    # one-accepted-step mode (RBCD): shrink radius /4 on rejection, <=10 tries
    single_accepted_step: bool = False
    max_rejections: int = 10


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------


class _RABackend:
    """RAState + edge-path cost engine (problem.py)."""

    agent_dim = None  # one problem (see tvdot)

    def applyQ(self, P, X):
        return prob.apply_Q(P, X)

    def hessvec(self, P, V):
        return prob.hessian_vec(P, V)

    def tangent(self, P, X, V):
        return tangent_project(X, V)

    def hess_setup(self, P, X, egrad):
        """sym(Y^T egrad) and the sphere inner products, once per outer."""
        S = torch.einsum("nri,nrj->nij", X.rot, egrad.rot)
        S = 0.5 * (S + S.transpose(1, 2))
        s_inner = (X.sph * egrad.sph).sum(dim=-1, keepdim=True)
        return S, s_inner

    def weingarten(self, P, X, eta, aux):
        S, s_inner = aux
        return RAState(rot=torch.einsum("nrd,nde->nre", eta.rot, S),
                       sph=eta.sph * s_inner, trn=torch.zeros_like(eta.trn))

    def precond(self, P, M, X, V):
        if M is None:
            return V  # V is already tangent
        return tangent_project(X, prob.apply_preconditioner(M, V))

    def retract(self, P, X, V):
        return retract(X, V)


class _FlatBackend:
    """Flat [r_pad, kpad] tensors over the tiled ordering (tiled.py).

    P is a tiled.TiledProblem (preconditioner included); M is ignored.
    A stack of agents' problems (parallel.rbcd.StackedFlatBackend) runs the
    same ops on [r_pad, A, kpad] tensors.
    """

    agent_dim = None

    def applyQ(self, P, X):
        return tiled.apply_tiled(P, X)

    def hessvec(self, P, V):
        return tiled.apply_tiled(P, V)

    def tangent(self, P, X, V):
        return tiled.tangent_project_flat(P.meta, X, V)

    def hess_setup(self, P, X, egrad):
        return tiled.weingarten_setup(P.meta, X, egrad)

    def weingarten(self, P, X, eta, aux):
        return tiled.weingarten_apply(P.meta, eta, aux)

    def precond(self, P, M, X, V):
        return tiled.tangent_project_flat(P.meta, X,
                                          tiled.precondition_flat(P, V))

    def retract(self, P, X, V):
        return tiled.retract_flat(P.meta, X, V)


RA_BACKEND = _RABackend()
FLAT_BACKEND = _FlatBackend()


def riemannian_gradient(P, X: RAState, G: Optional[RAState]) -> RAState:
    return tangent_project(X, prob.euclidean_gradient(P, X, G))


def _rhess(be, P, X, eta, aux):
    H = tmap(torch.sub, be.hessvec(P, eta), be.weingarten(P, X, eta, aux))
    return be.tangent(P, X, H)


class _DoneProbe:
    """Non-blocking view of a device-side convergence flag.

    On a CUDA device each posted flag is copied into pinned host memory
    behind an event; `finished()` reads only flags whose copy has already
    completed (Event.query does not wait), so the loop never stalls on the
    device until the host is `ring` posts ahead of it.  On the CPU the flag
    is read directly.
    """

    RING = 64

    def __init__(self, device: torch.device, ring: int = RING):
        self.cuda = device.type == "cuda"
        self.seen = False
        self.RING = ring
        if self.cuda:
            self.host = torch.zeros(self.RING, dtype=torch.bool,
                                    pin_memory=True)
            self.pending = []  # (event, slot), oldest first
            self.next = 0

    def _read_oldest(self):
        _, slot = self.pending.pop(0)
        self.seen = self.seen or bool(self.host[slot])

    def post(self, flag: torch.Tensor):
        if not self.cuda:
            self.seen = bool(flag)
            return
        if len(self.pending) == self.RING:
            # the host is a full ring ahead of the device: waiting on the
            # oldest copy costs nothing the device was not already spending
            self.pending[0][0].synchronize()
            self._read_oldest()
        slot = self.next
        self.next = (self.next + 1) % self.RING
        self.host[slot].copy_(flag, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.pending.append((ev, slot))

    def finished(self) -> bool:
        if self.cuda:
            while not self.seen and self.pending and \
                    self.pending[0][0].query():
                self._read_oldest()
        return self.seen


class TCGResult(NamedTuple):
    eta: object
    Heta: object
    inner_iters: torch.Tensor


class _TCGState(NamedTuple):
    eta: object
    Heta: object
    r: object
    z: object
    d: object
    rz: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor


def _tcg_step(be, P, M, X, aux, radius, stop_tol, max_inner: int,
              s: _TCGState) -> _TCGState:
    """One Steihaug-Toint iteration.  After the iteration that converges
    (boundary hit, negative curvature, a small residual or the max_inner-th
    step) eta, Heta and the count are frozen by masking, so iterations
    issued after it leave the result unchanged.  On a stack of agents
    (be.agent_dim set) every scalar and flag is one per agent."""
    ax = be.agent_dim
    eta, Heta, r, z, d, rz, it, done = s
    Hd = _rhess(be, P, X, d, aux)
    dHd = tvdot(d, Hd, ax)
    alpha = rz / torch.where(dHd == 0, torch.ones_like(dHd), dHd)
    eta_next = taxpy(alpha, d, eta, ax)
    hit = (dHd <= 0) | (tnorm(eta_next, ax) >= radius)
    # largest tau >= 0 with ||eta + tau d|| = radius
    dd = tvdot(d, d, ax)
    ed = tvdot(eta, d, ax)
    ee = tvdot(eta, eta, ax)
    disc = torch.clamp(ed * ed - dd * (ee - radius ** 2), min=0.0)
    tau = (-ed + torch.sqrt(disc)) / torch.where(dd == 0,
                                                 torch.ones_like(dd), dd)
    eta_new = twhere(hit, taxpy(tau, d, eta, ax), eta_next, ax)
    Heta_new = twhere(hit, taxpy(tau, Hd, Heta, ax),
                      taxpy(alpha, Hd, Heta, ax), ax)
    r = taxpy(alpha, Hd, r, ax)
    z = be.precond(P, M, X, r)
    rz_new = tvdot(r, z, ax)
    small = tnorm(r, ax) <= stop_tol
    beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
    d = taxpy(beta, d, tscale(z, -1.0), ax)
    # masked commit: a converged solve keeps its eta, Heta and count
    eta = twhere(done, eta, eta_new, ax)
    Heta = twhere(done, Heta, Heta_new, ax)
    it = it + (~done).to(torch.int32)
    done = done | hit | small | (it >= max_inner)
    return _TCGState(eta, Heta, r, z, d, rz_new, it, done)


def _flatten(tree) -> list:
    return [leaf for x in tree for leaf in _leaves(x)]


def _unflatten(like, leaves) -> list:
    out, i = [], 0
    for x in like:
        k = len(_leaves(x))
        out.append(_rebuild(x, leaves[i:i + k]))
        i += k
    return out


class TCGGraph:
    """STEPS tCG iterations of the edge path captured once per RTR call as
    a CUDA graph and replayed until the solve converges.

    Issued from Python, one iteration on the range-aided edge path is ~200
    small kernels whose host issue time exceeds their device time.  Every
    update of an iteration is masked (_tcg_step), so the iterations need no
    host decision and can be recorded once.  The graph reads its inputs
    (X, the Weingarten terms, radius, the stopping tolerance) from static
    buffers and writes the tCG state back into its own static buffers;
    `load` copies an outer iteration's values in.  The kernel launches it
    records (the segment sums of apply_Q) count once per replay."""

    STEPS = 4

    def __init__(self, be, P, M, max_inner: int):
        self.be, self.P, self.M, self.max_inner = be, P, M, max_inner
        self.graph = None
        self.per_replay = {}  # kernel launches the captured graph records

    def _capture(self, inputs, state):
        self.inputs = [x.clone() for x in _flatten(inputs)]
        self.state = [x.clone() for x in _flatten(state)]
        X, *aux, radius, stop_tol = _unflatten(inputs, self.inputs)
        aux = tuple(aux)

        def body():
            s = _TCGState(*_unflatten(state, self.state))
            for _ in range(self.STEPS):
                s = _tcg_step(self.be, self.P, self.M, X, aux, radius,
                              stop_tol, self.max_inner, s)
            for dst, src in zip(self.state, _flatten(s)):
                dst.copy_(src)

        self._record(body)

    def _record(self, body):
        dev = self.state[0].device
        # warm up on a side stream before capture, as torch.cuda.graphs
        # requires; `load` overwrites what the warm-up wrote
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = kernels.captured_counts()
        with torch.cuda.graph(self.graph):
            body()
        self.per_replay = {k: v - before[k]
                           for k, v in kernels.captured_counts().items()}

    def load(self, X, aux, radius, stop_tol, state: _TCGState):
        inputs = (X, *aux, radius, stop_tol)
        if self.graph is None:
            self._capture(inputs, state)
        for dst, src in zip(self.inputs + self.state,
                            _flatten(inputs) + _flatten(state)):
            dst.copy_(src)

    def replay(self) -> torch.Tensor:
        """STEPS iterations; returns the (static) convergence flag."""
        self.graph.replay()
        kernels.add_replays(self.per_replay)
        return self.state[-1]


def _all(flag: torch.Tensor) -> torch.Tensor:
    return flag if flag.dim() == 0 else flag.all()


def truncated_cg(P, X, grad, egrad, M, radius, max_inner: int,
                 kappa: float, theta: float, be=RA_BACKEND,
                 graph: Optional[TCGGraph] = None,
                 done0: Optional[torch.Tensor] = None) -> TCGResult:
    """Preconditioned Steihaug-Toint tCG for the trust-region subproblem.

    Iterations are issued one by one, or, when `graph` is given, STEPS at a
    time by replaying it; either way the host stops issuing them once it
    sees the device-side convergence flag, a few iterations late at most,
    and those change nothing (_tcg_step).  On a stack of agents `done0`
    marks the agents whose solve is not wanted; the host stops when every
    agent's solve has converged."""
    ax = be.agent_dim
    zero = tmap(torch.zeros_like, grad)
    r = grad
    z = be.precond(P, M, X, r)
    d = tscale(z, -1.0)
    r0_norm = tnorm(r, ax)
    stop_tol = r0_norm * torch.clamp(r0_norm ** theta, max=kappa)
    aux = be.hess_setup(P, X, egrad)
    it = torch.zeros_like(r0_norm, dtype=torch.int32)
    done = r0_norm < 1e-300
    if done0 is not None:
        done = done | done0
    s = _TCGState(zero, zero, r, z, d, tvdot(r, z, ax), it, done)
    if graph is None:
        probe = _DoneProbe(r0_norm.device)
        probe.post(_all(done))
        for _ in range(max_inner):
            if probe.finished():
                break
            s = _tcg_step(be, P, M, X, aux, radius, stop_tol, max_inner, s)
            probe.post(_all(s.done))
        return TCGResult(eta=s.eta, Heta=s.Heta, inner_iters=s.it)
    graph.load(X, aux, radius, stop_tol, s)
    # two replays in flight: the device never waits for the host, and the
    # host overshoots convergence by at most 2 * STEPS masked iterations
    probe = _DoneProbe(r0_norm.device, ring=2)
    probe.post(_all(done))
    for _ in range(-(-max_inner // graph.STEPS)):
        if probe.finished():
            break
        probe.post(_all(graph.replay()))
    s = _TCGState(*_unflatten(s, [x.clone() for x in graph.state]))
    return TCGResult(eta=s.eta, Heta=s.Heta, inner_iters=s.it)


class RTRResult(NamedTuple):
    X: object
    f_final: torch.Tensor
    gradnorm_final: torch.Tensor
    outer_iters: int
    accepted: bool  # whether any step was accepted
    # final trust-region radius; pass back as `radius0` to continue a solve
    radius_final: Optional[torch.Tensor] = None


def rtr(P, G, M, X0, cfg: RTRConfig, be=RA_BACKEND,
        radius0=None, graph: Optional[TCGGraph] = None) -> RTRResult:
    """Riemannian trust region from X0 until gradnorm < cfg.gradnorm_tol or
    cfg.max_outer outer iterations.  One host sync per outer iteration.

    On the card the edge path's tCG replays `graph` (a TCGGraph over the
    same P, M and cfg.max_inner, kept by a caller that solves the same
    problem many times), or one captured for this call."""
    lead = _leaves(X0)[0]
    max_radius = cfg.initial_radius * cfg.max_radius_factor
    radius = torch.as_tensor(cfg.initial_radius if radius0 is None
                             else radius0, dtype=lead.dtype,
                             device=lead.device)

    def f_of(X, W):
        fX = 0.5 * tvdot(W, X)
        if G is not None:
            fX = fX + tvdot(X, G)
        return fX

    def egrad_of(W):
        return W if G is None else tadd(W, G)

    eps = torch.finfo(lead.dtype).eps
    # the edge path's tCG iterations replay a CUDA graph on the card; the
    # flat backend's kernel wrappers count their launches and stay eager
    if not (lead.is_cuda and be is RA_BACKEND):
        graph = None
    elif graph is None:
        graph = TCGGraph(be, P, M, cfg.max_inner)

    def try_step(X, W, radius):
        """One trust-region step proposal."""
        fX = f_of(X, W)
        egrad = egrad_of(W)
        grad = be.tangent(P, X, egrad)
        res = truncated_cg(P, X, grad, egrad, M, radius, cfg.max_inner,
                           cfg.kappa, cfg.theta, be=be, graph=graph)
        Xtest = be.retract(P, X, res.eta)
        Wtest = be.applyQ(P, Xtest)
        ftest = f_of(Xtest, Wtest)
        model_decrease = -(tvdot(grad, res.eta)
                           + 0.5 * tvdot(res.eta, res.Heta))
        reg = cfg.rho_regularization * eps * torch.clamp(fX.abs(), min=1.0)
        den = model_decrease + reg
        rho = (fX - ftest + reg) / torch.where(
            den.abs() < 1e-300, torch.full_like(den, 1e-300), den)
        accept = (rho > cfg.rho_accept) & (ftest <= fX + reg)
        hit_boundary = tnorm(res.eta) >= 0.99 * radius
        return (twhere(accept, Xtest, X), twhere(accept, Wtest, W), rho,
                accept, hit_boundary)

    X, W = X0, be.applyQ(P, X0)
    gnorm = tnorm(be.tangent(P, X, egrad_of(W)))
    it = 0
    done = bool(gnorm < cfg.gradnorm_tol)
    any_acc = done
    if cfg.single_accepted_step:
        # RBCD mode (QuadraticOptimizer.cpp:253-273): shrink the radius (/4)
        # after every try until one step is accepted, at most
        # max_rejections + 1 tries; skipped when already below tolerance
        # (QuadraticOptimizer.cpp:54-56)
        accepted = done
        while it <= cfg.max_rejections and not accepted:
            X, W, _, accept, _ = try_step(X, W, radius)
            radius = radius / 4.0
            it += 1
            accepted = bool(accept)
        return RTRResult(X=X, f_final=f_of(X, W),
                         gradnorm_final=tnorm(be.tangent(P, X, egrad_of(W))),
                         outer_iters=it, accepted=accepted or done,
                         radius_final=radius)
    while it < cfg.max_outer and not done:
        X, W, rho, accept, hit_boundary = try_step(X, W, radius)
        radius = torch.where(
            rho < 0.25, radius / 4.0,
            torch.where(hit_boundary & (rho > 0.75),
                        torch.clamp(2.0 * radius, max=max_radius), radius))
        gnorm = tnorm(be.tangent(P, X, egrad_of(W)))
        it += 1
        flags = torch.stack([gnorm < cfg.gradnorm_tol, accept]).tolist()
        done = flags[0]
        any_acc = any_acc or flags[1]
    return RTRResult(X=X, f_final=f_of(X, W), gradnorm_final=gnorm,
                     outer_iters=it, accepted=any_acc,
                     radius_final=radius)


def rtr_stacked(P, G, M, X0, cfg: RTRConfig, be,
                graph: Optional[TCGGraph] = None) -> RTRResult:
    """The one-accepted-step RTR of RBCD (cfg.single_accepted_step) for
    every agent of a stack at once, along be.agent_dim.

    Each agent gets what `rtr` gives it alone, as under the JAX package's
    vmap: its own radius, tries and tCG stopping state (every scalar is an
    [A] tensor), and once it has accepted a step, or when it starts below
    cfg.gradnorm_tol, it keeps its state.  Its tCG stops with its own flag;
    the host stops issuing iterations when every agent's has converged, and
    stops trying when no agent is left.  `graph` is a TCGGraph of the
    stack's edge path on the card (None issues the iterations one by one).
    Returns per-agent f_final, gradnorm_final, outer_iters and accepted."""
    ax = be.agent_dim
    lead = _leaves(X0)[0]
    A = lead.shape[ax]
    radius = torch.full((A,), cfg.initial_radius, dtype=lead.dtype,
                        device=lead.device)
    eps = torch.finfo(lead.dtype).eps

    def f_of(X, W):
        fX = 0.5 * tvdot(W, X, ax)
        if G is not None:
            fX = fX + tvdot(X, G, ax)
        return fX

    def egrad_of(W):
        return W if G is None else tadd(W, G)

    X, W = X0, be.applyQ(P, X0)
    below = tnorm(be.tangent(P, X, egrad_of(W)), ax) < cfg.gradnorm_tol
    active = ~below
    tries = torch.zeros(A, dtype=torch.int32, device=lead.device)
    accepted = below
    for _ in range(cfg.max_rejections + 1):
        if not bool(active.any()):
            break
        fX = f_of(X, W)
        egrad = egrad_of(W)
        grad = be.tangent(P, X, egrad)
        res = truncated_cg(P, X, grad, egrad, M, radius, cfg.max_inner,
                           cfg.kappa, cfg.theta, be=be, graph=graph,
                           done0=~active)
        Xtest = be.retract(P, X, res.eta)
        Wtest = be.applyQ(P, Xtest)
        ftest = f_of(Xtest, Wtest)
        model_decrease = -(tvdot(grad, res.eta, ax)
                           + 0.5 * tvdot(res.eta, res.Heta, ax))
        reg = cfg.rho_regularization * eps * torch.clamp(fX.abs(), min=1.0)
        den = model_decrease + reg
        rho = (fX - ftest + reg) / torch.where(
            den.abs() < 1e-300, torch.full_like(den, 1e-300), den)
        take = active & (rho > cfg.rho_accept) & (ftest <= fX + reg)
        X = twhere(take, Xtest, X, ax)
        W = twhere(take, Wtest, W, ax)
        radius = torch.where(active, radius / 4.0, radius)
        tries = tries + active.to(torch.int32)
        accepted = accepted | take
        active = active & ~take & (tries <= cfg.max_rejections)
    return RTRResult(X=X, f_final=f_of(X, W),
                     gradnorm_final=tnorm(be.tangent(P, X, egrad_of(W)), ax),
                     outer_iters=tries, accepted=accepted,
                     radius_final=radius)


def rgd_step(P, G, M, X: RAState, stepsize: float) -> RAState:
    """Single preconditioned Riemannian gradient step
    (reference: QuadraticOptimizer.cpp:110-180)."""
    grad = riemannian_gradient(P, X, G)
    if M is not None:
        grad = RA_BACKEND.precond(P, M, X, grad)
    return retract(X, grad.scale(-stepsize))
