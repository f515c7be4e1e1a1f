"""Matrix-free quadratic cost engine (the edge path).

Counterpart of ``dcora_tpu.core.problem``.  Implements the lifted cost
f(X) = 0.5 <Q, X^T X> + <X, G>  (reference: QuadraticProblem.h:30-40,
QuadraticProblem.cpp:38-84) without forming a sparse matrix: Q is held as
its measurement SoA and applied by gather -> batched einsum -> segment sum
(``core/segment.py``: on the card the deterministic kernel
``csrc/segment_sum.cu``, one launch per output block).

Closed-form per-edge blocks of Q (RA ordering; w = weight, kw = w*kappa,
tw = w*tau, om = w*precision), applied to the state with the residual
s = Y_i t + t_i - t_j and g = rho*s_q + (t_b - t_a):

      (XQ)_rot_i += kw (Y_i - Y_j R^T) + tw s (x) t
      (XQ)_rot_j += kw (Y_j - Y_i R)
      (XQ)_trn_i += tw s          (XQ)_trn_j -= tw s
      (XQ)_sph_q += om rho g
      (XQ)_trn_a -= om g          (XQ)_trn_b += om g

Any edge-endpoint index equal to the size of its part of X addresses an
implicit zero padding row, exactly as in the JAX package.  The ELL form of
the JAX package (a TPU gather workaround) is not ported: the residual form
here is also the one that keeps full precision near the optimum.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.segment import SegmentMap, build_map, segment_sum


class Segments(NamedTuple):
    """The segment maps of apply_Q's three output blocks, over the index
    fields in the order apply_Q concatenates its contributions; one part
    per edge kind (pose-pose | pose-landmark | range)."""

    rot: SegmentMap  # pp_ri, pp_rj | pl_ri
    trn: SegmentMap  # pp_ti, pp_tj | pl_ti, pl_tj | rg_ti, rg_tj
    sph: SegmentMap  # rg_q


class ProblemData(NamedTuple):
    """Measurement SoA over the augmented index space (local slots first).

    Index spaces:
      rotation blocks: [0, n_local) local poses, then fixed neighbor poses
      translations:    [0, n_local) pose trans, [n_local, n_local+b)
                       landmarks, then fixed neighbor translations
      spheres:         [0, l_local) local, then fixed neighbor spheres
    Index tensors are int64 (torch's index type); float tensors float64.
    """

    pp_ri: torch.Tensor  # [mpp] tail rotation index
    pp_rj: torch.Tensor  # [mpp] head rotation index
    pp_ti: torch.Tensor  # [mpp] tail translation index
    pp_tj: torch.Tensor  # [mpp] head translation index
    pp_R: torch.Tensor  # [mpp, d, d]
    pp_t: torch.Tensor  # [mpp, d]
    pp_kappa: torch.Tensor  # [mpp]
    pp_tau: torch.Tensor  # [mpp]
    pp_w: torch.Tensor  # [mpp] robust weight
    pp_active: torch.Tensor  # [mpp] activity mask (0/1)

    pl_ri: torch.Tensor
    pl_ti: torch.Tensor
    pl_tj: torch.Tensor
    pl_t: torch.Tensor
    pl_tau: torch.Tensor
    pl_w: torch.Tensor
    pl_active: torch.Tensor

    rg_ti: torch.Tensor
    rg_tj: torch.Tensor
    rg_q: torch.Tensor
    rg_rho: torch.Tensor
    rg_prec: torch.Tensor
    rg_w: torch.Tensor
    rg_active: torch.Tensor

    # linear prior term over LOCAL slots (reference: Graph.cpp:805-817)
    prior_G: Optional[RAState] = None
    # quadratic prior diagonals over LOCAL slots (Graph.cpp:314-331)
    prior_kdiag: Optional[torch.Tensor] = None  # [n]
    prior_tdiag: Optional[torch.Tensor] = None  # [n+b]
    # the segment maps of the index fields (with_segments): a layout detail
    # of the port, which the JAX ProblemData does not have.  apply_Q needs
    # them; whoever changes an index field rebuilds them
    seg: Optional[Segments] = None

    @property
    def num_pose_pose(self) -> int:
        return self.pp_ri.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pp_R.device


_INDEX_FIELDS = ("pp_ri", "pp_rj", "pp_ti", "pp_tj", "pl_ri", "pl_ti",
                 "pl_tj", "rg_ti", "rg_tj", "rg_q")


def problem_data_from_arrays(arrays: dict, device="cpu") -> ProblemData:
    """Build ProblemData from host arrays keyed by field name.

    ``prior_G`` may be an RAState or a (rot, sph, trn) triple of arrays."""
    out = {}
    for name in ProblemData._fields:
        a = arrays.get(name)
        if a is None:
            out[name] = None
        elif name == "prior_G":
            out[name] = RAState(*(torch.tensor(np.asarray(x),
                                               dtype=torch.float64,
                                               device=device)
                                  for x in a))
        elif name in _INDEX_FIELDS:
            out[name] = torch.tensor(np.asarray(a, dtype=np.int64),
                                     device=device)
        else:
            out[name] = torch.tensor(np.asarray(a, dtype=np.float64),
                                     device=device)
    return with_segments(ProblemData(**out))


def with_segments(P: ProblemData) -> ProblemData:
    """P with the segment maps of its current index fields, on P's device
    (built on the host)."""
    dev = P.device
    return P._replace(seg=Segments(
        rot=build_map([(P.pp_ri, P.pp_rj), (P.pl_ri,)], dev),
        trn=build_map([(P.pp_ti, P.pp_tj), (P.pl_ti, P.pl_tj),
                       (P.rg_ti, P.rg_tj)], dev),
        sph=build_map([(P.rg_q,)], dev)))


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.zeros((1,) + x.shape[1:], dtype=x.dtype,
                                     device=x.device)])


def edge_contributions(P: ProblemData, X: RAState):
    """The per-edge terms of X Q for apply_Q's three output blocks
    (rotations [K, r, d], translations [K, r], spheres [K, r]), each in the
    order of the index array of its map in Segments."""
    r, d = X.rot.shape[1:]
    rot_pad = _pad_row(X.rot)
    trn_pad = _pad_row(X.trn)
    sph_pad = _pad_row(X.sph)
    c_rot, c_trn, c_sph = [], [], []

    if P.pp_ri.shape[0] > 0:
        kw = P.pp_kappa * P.pp_w * P.pp_active
        tw = P.pp_tau * P.pp_w * P.pp_active
        Yi = rot_pad[P.pp_ri]  # [m, r, d]
        Yj = rot_pad[P.pp_rj]
        ti = trn_pad[P.pp_ti]  # [m, r]
        tj = trn_pad[P.pp_tj]
        s = torch.einsum("mrd,md->mr", Yi, P.pp_t) + ti - tj
        c_rot.append(kw[:, None, None] * (
            Yi - torch.einsum("mre,mde->mrd", Yj, P.pp_R)
        ) + tw[:, None, None] * (s[:, :, None] * P.pp_t[:, None, :]))
        c_rot.append(kw[:, None, None] * (
            Yj - torch.einsum("mre,med->mrd", Yi, P.pp_R)))
        tws = tw[:, None] * s
        c_trn += [tws, -tws]

    if P.pl_ri.shape[0] > 0:
        tw = P.pl_tau * P.pl_w * P.pl_active
        Yi = rot_pad[P.pl_ri]
        ti = trn_pad[P.pl_ti]
        tj = trn_pad[P.pl_tj]
        s = torch.einsum("mrd,md->mr", Yi, P.pl_t) + ti - tj
        c_rot.append(tw[:, None, None] * (s[:, :, None]
                                          * P.pl_t[:, None, :]))
        tws = tw[:, None] * s
        c_trn += [tws, -tws]

    if P.rg_ti.shape[0] > 0:
        om = P.rg_prec * P.rg_w * P.rg_active
        ta = trn_pad[P.rg_ti]
        tb = trn_pad[P.rg_tj]
        sq = sph_pad[P.rg_q]
        g = P.rg_rho[:, None] * sq + tb - ta
        c_sph.append((om * P.rg_rho)[:, None] * g)
        omg = om[:, None] * g
        c_trn += [-omg, omg]

    def cat(parts, shape):
        return torch.cat(parts) if parts else X.rot.new_zeros((0,) + shape)

    return cat(c_rot, (r, d)), cat(c_trn, (r,)), cat(c_sph, (r,))


def apply_Q(P: ProblemData, X: RAState) -> RAState:
    """W = X Q arranged in the same block layout as X (Q is symmetric).

    Replaces EucHessianEta / EucGrad SpMV (QuadraticProblem.cpp:53-68).
    Each output block is one segment sum over P.seg, which P must carry
    (raises otherwise).
    """
    seg = P.seg
    if seg is None:
        raise ValueError("apply_Q: the ProblemData has no segment maps "
                         "(problem.with_segments)")
    c_rot, c_trn, c_sph = edge_contributions(P, X)
    out_rot = segment_sum(c_rot, seg.rot, X.rot.shape[0])
    out_trn = segment_sum(c_trn, seg.trn, X.trn.shape[0])
    out_sph = segment_sum(c_sph, seg.sph, X.sph.shape[0])

    if P.prior_kdiag is not None:
        n_loc = P.prior_kdiag.shape[0]
        kd = P.prior_kdiag.to(X.rot.dtype)
        out_rot[:n_loc] += kd[:, None, None] * X.rot[:n_loc]
    if P.prior_tdiag is not None:
        t_loc = P.prior_tdiag.shape[0]
        td = P.prior_tdiag.to(X.rot.dtype)
        out_trn[:t_loc] += td[:, None] * X.trn[:t_loc]

    return RAState(rot=out_rot, sph=out_sph, trn=out_trn)


def augment(X_local: RAState, X_fixed: Optional[RAState]) -> RAState:
    """Concatenate local and fixed-neighbor states into the augmented space."""
    if X_fixed is None:
        return X_local
    return RAState(*(torch.cat([a, b]) for a, b in zip(X_local, X_fixed)))


def restrict(X_aug: RAState, n: int, l: int,  # noqa: E741
             num_trans: int) -> RAState:
    """Slice the local block out of an augmented state."""
    return RAState(rot=X_aug.rot[:n], sph=X_aug.sph[:l],
                   trn=X_aug.trn[:num_trans])


def linear_term(P: ProblemData, X_fixed: Optional[RAState], n: int,
                l: int, num_trans: int) -> Optional[RAState]:  # noqa: E741
    """G = X_fixed^T Q_cb restricted to local slots, plus the prior term
    (reference: Graph.cpp:685-822, 1190-1772)."""
    G = None
    if X_fixed is not None:
        r, d = X_fixed.rot.shape[1], X_fixed.rot.shape[2]
        kw = dict(dtype=X_fixed.rot.dtype, device=X_fixed.rot.device)
        zeros_local = RAState(rot=torch.zeros((n, r, d), **kw),
                              sph=torch.zeros((l, r), **kw),
                              trn=torch.zeros((num_trans, r), **kw))
        G = restrict(apply_Q(P, augment(zeros_local, X_fixed)), n, l,
                     num_trans)
    if P.prior_G is not None:
        G = P.prior_G if G is None else G + P.prior_G
    return G


def cost(P: ProblemData, X: RAState, G: Optional[RAState] = None):
    """f(X) = 0.5 <XQ, X> + <X, G> (reference: QuadraticProblem.cpp:38-51)."""
    f = 0.5 * apply_Q(P, X).vdot(X)
    if G is not None:
        f = f + X.vdot(G)
    return f


def euclidean_gradient(P: ProblemData, X: RAState,
                       G: Optional[RAState] = None) -> RAState:
    """XQ + G (reference: QuadraticProblem.cpp:53-59)."""
    W = apply_Q(P, X)
    return W if G is None else W + G


def hessian_vec(P: ProblemData, V: RAState) -> RAState:
    """V Q (reference: QuadraticProblem.cpp:61-68)."""
    return apply_Q(P, V)


# --------------------------------------------------------------------------
# Block-Jacobi preconditioner (replacement for the reference's CHOLMOD
# preconditioner, Graph.cpp:1901-1960 / QuadraticProblem.cpp:70-84):
# per-pose (d+1)x(d+1) diagonal blocks of Q in the SE-interleaved basis,
# scalar diagonals for spheres and landmarks.
# --------------------------------------------------------------------------


class Preconditioner(NamedTuple):
    pose_inv: torch.Tensor  # [n, d+1, d+1] explicit block inverses
    sph_diag: torch.Tensor  # [l]
    lmk_diag: torch.Tensor  # [b]


def build_preconditioner_host(P: ProblemData, n: int, l: int,  # noqa: E741
                              b: int, d: int, reg: float,
                              device=None) -> Preconditioner:
    """Assemble and invert the block-diagonal of Q restricted to local slots,
    in numpy on the host (dcora_tpu.core.problem.build_preconditioner_host).

    reg is the regularization (reference rule: 1e-1 for PGO,
    lambda_max/(1e6-1) for RA-SLAM; Graph.cpp:1901-1960).  The result is
    placed on `device` (default: P's device)."""
    dh = d + 1

    def a(x):
        return x.detach().cpu().numpy()

    blocks = np.zeros((n, dh, dh))
    lmk = np.zeros((b,))
    sph = np.zeros((l,))

    if P.pp_ri.shape[0] > 0:
        kw = a(P.pp_kappa) * a(P.pp_w) * a(P.pp_active)
        tw = a(P.pp_tau) * a(P.pp_w) * a(P.pp_active)
        t = a(P.pp_t)
        m = t.shape[0]
        tail = np.zeros((m, dh, dh))
        tail[:, :d, :d] = (kw[:, None, None] * np.eye(d)
                           + tw[:, None, None] * t[:, :, None]
                           * t[:, None, :])
        tail[:, :d, d] = tw[:, None] * t
        tail[:, d, :d] = tw[:, None] * t
        tail[:, d, d] = tw
        head = np.zeros((m, dh, dh))
        head[:, :d, :d] = kw[:, None, None] * np.eye(d)
        head[:, d, d] = tw
        contrib = np.concatenate([tail, head])
        idx = np.concatenate([a(P.pp_ri), a(P.pp_rj)])
        ok = idx < n
        np.add.at(blocks, idx[ok], contrib[ok])

    if P.pl_ri.shape[0] > 0:
        tw = a(P.pl_tau) * a(P.pl_w) * a(P.pl_active)
        t = a(P.pl_t)
        m = t.shape[0]
        tail = np.zeros((m, dh, dh))
        tail[:, :d, :d] = tw[:, None, None] * t[:, :, None] * t[:, None, :]
        tail[:, :d, d] = tw[:, None] * t
        tail[:, d, :d] = tw[:, None] * t
        tail[:, d, d] = tw
        ri = a(P.pl_ri)
        ok = ri < n
        np.add.at(blocks, ri[ok], tail[ok])
        jidx = a(P.pl_tj) - n
        ok = (jidx >= 0) & (jidx < b)
        np.add.at(lmk, jidx[ok], tw[ok])

    if P.rg_ti.shape[0] > 0:
        om = a(P.rg_prec) * a(P.rg_w) * a(P.rg_active)
        q = a(P.rg_q)
        ok = q < l
        np.add.at(sph, q[ok], (om * a(P.rg_rho) ** 2)[ok])
        for tidx in (a(P.rg_ti), a(P.rg_tj)):
            ok = tidx < n
            np.add.at(blocks, (tidx[ok], d, d), om[ok])
            lm = tidx - n
            ok = (lm >= 0) & (lm < b)
            np.add.at(lmk, lm[ok], om[ok])

    if P.prior_kdiag is not None:
        kd = a(P.prior_kdiag)
        for i in range(d):
            blocks[:, i, i] += kd
    if P.prior_tdiag is not None:
        td = a(P.prior_tdiag)
        blocks[:, d, d] += td[:n]
        lmk += td[n:]

    blocks = blocks + reg * np.eye(dh)
    inv = np.linalg.inv(blocks)
    dev = P.device if device is None else device

    def t_(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    return Preconditioner(pose_inv=t_(inv), sph_diag=t_(sph + reg),
                          lmk_diag=t_(lmk + reg))


def apply_preconditioner(M: Preconditioner, V: RAState) -> RAState:
    """Solve the block-diagonal system (reference: QuadraticProblem.cpp:70-84).

    Tangent projection is applied by the caller (as in the reference)."""
    n = M.pose_inv.shape[0]
    b = M.lmk_diag.shape[0]
    pose_v = torch.cat([V.rot, V.trn[:n, :, None]], dim=2)
    sol = torch.einsum("nrd,nde->nre", pose_v, M.pose_inv.to(V.rot.dtype))
    trn_lmk = V.trn[n:] / M.lmk_diag[:, None] if b else V.trn[n:]
    sd = M.sph_diag
    sph = V.sph / torch.where(sd == 0, torch.ones_like(sd), sd)[:, None]
    return RAState(rot=sol[:, :, :-1], sph=sph,
                   trn=torch.cat([sol[:, :, -1], trn_lmk]))


def power_iteration_lambda_max(P: ProblemData, dims_probe: RAState,
                               iters: int = 50) -> torch.Tensor:
    """Estimate lambda_max(Q) by power iteration on apply_Q (replaces the
    Spectra largest-eigenvalue solve, Graph.cpp:1919-1960).  dims_probe
    gives the shape, dtype and device of a rank-1 state."""
    v = RAState(*(torch.ones_like(x) for x in dims_probe))
    nrm = v.norm()
    v = v.scale(1.0 / torch.where(nrm == 0, torch.ones_like(nrm), nrm))
    lam = torch.zeros((), dtype=v.dtype, device=v.device)
    for _ in range(iters):
        w = apply_Q(P, v)
        lam = w.norm()
        v = w.scale(1.0 / torch.where(lam == 0, torch.ones_like(lam), lam))
    return lam
