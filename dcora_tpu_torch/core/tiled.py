"""Block-sparse tiled form of Q and the flat state layout.

Counterpart of ``dcora_tpu.core.tiled``.  Reordering the pose graph with
reverse Cuthill-McKee collapses the scalar matrix Q into a narrow band, so
Q partitions into a few hundred dense 128x128 tiles (the JAX package's
unit of work for the TPU's matrix unit).  Q is symmetric, so only its
upper-triangular tiles are stored.  The product W = X Q runs through a
hand-written kernel of :mod:`dcora_tpu_torch.core.spmm` that reads only
the non-empty ``spmm.BLOCK``-sized sub-blocks of those tiles: the
owner-computes strip kernel by default, or the grouped kernel on the
compacted two-row K-fused packs when the build packs the tiles in pairs
(``pack="paired"``, or ``DCORA_SPMM_PACK=paired`` as in the JAX
package).

Layout contract
---------------
The flat state is one tensor  Xf in R^{r_pad x kpad}  over the *tiled scalar
ordering*: poses first (RCM order, interleaved [Y_i | p_i]), then unit
spheres, then landmarks (each section sorted by RCM rank), zero-padded to
kpad = nt * T.  Zero rank rows above the working rank stay zero under every
op here.  Only *local* variables appear: endpoints on fixed neighbor slots
are dropped at build time (their coupling belongs to the linear term G).
A stack of A agents' problems that share one TiledMeta
(``dcora_tpu_torch.parallel.rbcd``) is one [r_pad, A, kpad] tensor, agent a
at scalar columns [a kpad, (a+1) kpad) of the [r_pad, A kpad] view: the
per-pose ops here take it as it is, its preconditioner leaves carry a
leading agent axis, and its block-diagonal strip CSR serves every agent in
one kernel launch per product.

Not ported from the JAX module: the planar layout and its Newton-Schulz
retraction (TPU lane-relayout workarounds) and the scan chunking with its
tile-list pre-padding (an XLA temp-memory workaround).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from dcora_tpu_torch.core import kernels, lifted
from dcora_tpu_torch.core import problem as prob
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.manifold import inv_sqrt_psd
from dcora_tpu_torch.core.spmm import (
    PairBlocks,
    StripCSR,
    build_output_csr,
    spmm_paired,
    spmm_sym,
    to_device,
)
from dcora_tpu_torch.core.spmm_pack import (
    build_row_pairs_bucketed,
    compact_buckets,
)
from dcora_tpu_torch.types import ProblemDims


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class TiledQ(NamedTuple):
    """Upper-triangular block-sparse Q over the tiled scalar ordering."""

    # the dense tiles: the per-tile kernel, the BTD factor, the certifier's
    # host Q and the plain reference read them
    tiles: torch.Tensor      # [m, T, T] stored tiles, row <= col, sorted
                             # by (col, row)
    tile_rows: torch.Tensor  # i64[m]
    tile_cols: torch.Tensor  # i64[m]
    # their non-empty sub-blocks as a block CSR over output strips, both
    # triangles, at the tile dtype (spmm.build_output_csr): spmm_sym's
    strips: StripCSR
    # permutations between RA scalar ordering and flat ordering
    ra_of_fl: torch.Tensor   # i64[kpad]; k points at an appended zero column
    fl_of_ra: torch.Tensor   # i64[k]
    # the two-row K-fused packs and their single-row leftover buckets
    # (spmm_pack.build_row_pairs_bucketed) compacted to their non-empty
    # sub-blocks (spmm_pack.compact_buckets) at the tile dtype; when set,
    # apply_tiled runs spmm_paired on them
    pairs: Optional[PairBlocks] = None


@dataclasses.dataclass(frozen=True)
class TiledMeta:
    """Static layout info."""

    d: int
    n: int
    l: int  # noqa: E741
    b: int
    T: int
    nt: int

    @property
    def dh(self) -> int:
        return self.d + 1

    @property
    def k(self) -> int:
        return self.dh * self.n + self.l + self.b

    @property
    def kpad(self) -> int:
        return self.nt * self.T

    @property
    def pose_end(self) -> int:
        return self.dh * self.n

    @property
    def sph_end(self) -> int:
        return self.dh * self.n + self.l


@dataclasses.dataclass
class TiledProblem:
    """Everything the flat solver needs on the device."""

    Q: TiledQ
    meta: TiledMeta
    pose_inv: torch.Tensor   # [n, dh, dh] block-Jacobi inverses, RCM order
    sph_inv: torch.Tensor    # [l]
    lmk_inv: torch.Tensor    # [b]
    # tile-granularity block-Jacobi: inverses of the regularized diagonal
    # T x T tiles
    diag_inv: Optional[torch.Tensor] = None   # [nt, T, T]
    # block-tridiagonal (RCM band) factorization M = (I+L~) S (I+L~)^T, see
    # _factor_btd
    btd_ltil: Optional[torch.Tensor] = None   # [nt, T, T] (L~_0 = 0)
    btd_sinv: Optional[torch.Tensor] = None   # [nt, T, T]
    # the factors laid out panel by panel for btd_solve's kernel
    # (_btd_layout), made at the first application on the card
    btd_layout: Optional[tuple] = dataclasses.field(default=None,
                                                    repr=False)
    # the Jacobi inverses (pose_inv, sph_inv, lmk_inv) per dtype, contiguous
    # (_jacobi); and the tCG's CUDA graphs on this problem
    # (rtr.tcg_graph), kept across RTR calls.  Neither is carried over by
    # dataclasses.replace.
    jacobi: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)
    tcg_graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.Q.tiles.dtype

    @property
    def device(self) -> torch.device:
        return self.Q.tiles.device


# --------------------------------------------------------------------------
# Host-side build (numpy; ports dcora_tpu.core.tiled almost verbatim)
# --------------------------------------------------------------------------


def _rcm_node_order(P: prob.ProblemData, dims: ProblemDims):
    """Reverse Cuthill-McKee over the variable graph (poses+spheres+lmks)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n, l, b = dims.n, dims.l, dims.b
    nn = n + l + b

    def node_of_trans(t):
        return np.where(t < n, t, n + l + (t - n))

    ei, ej = [], []

    def add(a, b_, ok):
        ei.append(a[ok])
        ej.append(b_[ok])

    pp_i = _np(P.pp_ri)
    pp_j = _np(P.pp_rj)
    add(pp_i, pp_j, (pp_i < n) & (pp_j < n))

    pl_i = _np(P.pl_ri)
    pl_j = _np(P.pl_tj)
    add(pl_i, node_of_trans(pl_j), (pl_i < n) & (pl_j >= n) & (pl_j < n + b))

    rg_a = _np(P.rg_ti)
    rg_b = _np(P.rg_tj)
    rg_q = _np(P.rg_q)
    add(node_of_trans(rg_a), node_of_trans(rg_b),
        (rg_a < n + b) & (rg_b < n + b))
    add(node_of_trans(rg_a), n + rg_q, (rg_q < l) & (rg_a < n + b))
    add(node_of_trans(rg_b), n + rg_q, (rg_q < l) & (rg_b < n + b))

    ei = np.concatenate(ei)
    ej = np.concatenate(ej)
    A = sp.coo_matrix((np.ones(len(ei)), (ei, ej)), shape=(nn, nn))
    order = reverse_cuthill_mckee((A + A.T).tocsr(), symmetric_mode=True)

    pose_rank = np.full(n, -1, np.int64)
    sph_rank = np.full(l, -1, np.int64)
    lmk_rank = np.full(b, -1, np.int64)
    pc = sc = lc = 0
    for node in order:
        if node < n:
            pose_rank[node] = pc
            pc += 1
        elif node < n + l:
            sph_rank[node - n] = sc
            sc += 1
        else:
            lmk_rank[node - n - l] = lc
            lc += 1
    return pose_rank, sph_rank, lmk_rank


def scalar_maps(dims: ProblemDims, pose_rank, sph_rank, lmk_rank,
                n_aug_pose: int, t_aug: int, l_aug: int):
    """Lookup arrays from augmented endpoint indices to scalar columns.

    -1 marks fixed-neighbor slots (dropped: their coupling lives in G).
    Returns (rot_base[n_aug_pose], trn_col[t_aug], sph_col[l_aug]).
    """
    n, l, b, dh = dims.n, dims.l, dims.b, dims.d + 1
    rot_base = np.full(max(n_aug_pose, 1), -1, np.int64)
    rot_base[:n] = pose_rank * dh
    trn_col = np.full(max(t_aug, 1), -1, np.int64)
    trn_col[:n] = pose_rank * dh + dims.d
    if b:
        trn_col[n:n + b] = n * dh + l + lmk_rank
    sph_col = np.full(max(l_aug, 1), -1, np.int64)
    if l:
        sph_col[:l] = n * dh + sph_rank
    return rot_base, trn_col, sph_col


def scalar_coo(P: prob.ProblemData, dims: ProblemDims,
               rot_base, trn_col, sph_col):
    """Scalar COO (rows, cols, vals) of the local Q under the given column
    maps: rotation entry (i, a) -> rot_base[i] + a, translation t ->
    trn_col[t], sphere q -> sph_col[q].  Entries mapping to -1 are dropped.

    Mirrors the closed-form per-edge blocks of Graph.cpp:579-683,824-1188.
    Duplicate entries are left for the caller to sum.
    """
    d = dims.d
    rows_all, cols_all, vals_all = [], [], []
    ar = np.arange(d)

    def emit(r_, c_, v):
        r_, c_, v = np.broadcast_arrays(r_, c_, v)
        ok = (r_ >= 0) & (c_ >= 0)
        rows_all.append(r_[ok].ravel())
        cols_all.append(c_[ok].ravel())
        vals_all.append(v[ok].ravel())

    def col_or_neg(base, idx):
        return np.where(idx < len(base), base[np.minimum(idx, len(base) - 1)],
                        -1)

    mpp = int(P.pp_ri.shape[0])
    if mpp:
        ri = col_or_neg(rot_base, _np(P.pp_ri))
        rj = col_or_neg(rot_base, _np(P.pp_rj))
        Ti = col_or_neg(trn_col, _np(P.pp_ti))
        Tj = col_or_neg(trn_col, _np(P.pp_tj))
        R = _np(P.pp_R)
        t = _np(P.pp_t)
        w = _np(P.pp_w) * _np(P.pp_active)
        kw = _np(P.pp_kappa) * w
        tw = _np(P.pp_tau) * w
        Ri = np.where(ri[:, None] >= 0, ri[:, None] + ar, -1)
        Rj = np.where(rj[:, None] >= 0, rj[:, None] + ar, -1)
        eye = np.eye(d)
        emit(Ri[:, :, None], Ri[:, None, :],
             kw[:, None, None] * eye
             + tw[:, None, None] * t[:, :, None] * t[:, None, :])
        emit(Rj, Rj, np.broadcast_to(kw[:, None], (mpp, d)))
        V = -kw[:, None, None] * R
        emit(Ri[:, :, None], Rj[:, None, :], V)
        emit(Rj[:, None, :], Ri[:, :, None], V)
        v = tw[:, None] * t
        emit(Ri, Ti[:, None], v)
        emit(Ti[:, None], Ri, v)
        emit(Ri, Tj[:, None], -v)
        emit(Tj[:, None], Ri, -v)
        emit(Ti, Ti, tw)
        emit(Tj, Tj, tw)
        emit(Ti, Tj, -tw)
        emit(Tj, Ti, -tw)

    mpl = int(P.pl_ri.shape[0])
    if mpl:
        ri = col_or_neg(rot_base, _np(P.pl_ri))
        Ti = col_or_neg(trn_col, _np(P.pl_ti))
        Tj = col_or_neg(trn_col, _np(P.pl_tj))
        t = _np(P.pl_t)
        tw = _np(P.pl_tau) * _np(P.pl_w) * _np(P.pl_active)
        Ri = np.where(ri[:, None] >= 0, ri[:, None] + ar, -1)
        emit(Ri[:, :, None], Ri[:, None, :],
             tw[:, None, None] * t[:, :, None] * t[:, None, :])
        v = tw[:, None] * t
        emit(Ri, Ti[:, None], v)
        emit(Ti[:, None], Ri, v)
        emit(Ri, Tj[:, None], -v)
        emit(Tj[:, None], Ri, -v)
        emit(Ti, Ti, tw)
        emit(Tj, Tj, tw)
        emit(Ti, Tj, -tw)
        emit(Tj, Ti, -tw)

    mrg = int(P.rg_ti.shape[0])
    if mrg:
        Ta = col_or_neg(trn_col, _np(P.rg_ti))
        Tb = col_or_neg(trn_col, _np(P.rg_tj))
        Sq = col_or_neg(sph_col, _np(P.rg_q))
        rho = _np(P.rg_rho)
        om = _np(P.rg_prec) * _np(P.rg_w) * _np(P.rg_active)
        emit(Sq, Sq, om * rho * rho)
        emit(Sq, Ta, -om * rho)
        emit(Ta, Sq, -om * rho)
        emit(Sq, Tb, om * rho)
        emit(Tb, Sq, om * rho)
        emit(Ta, Ta, om)
        emit(Tb, Tb, om)
        emit(Ta, Tb, -om)
        emit(Tb, Ta, -om)

    if P.prior_kdiag is not None:
        kd = _np(P.prior_kdiag)
        base = rot_base[:dims.n]
        Ri = np.where(base[:, None] >= 0, base[:, None] + ar, -1)
        emit(Ri, Ri, np.broadcast_to(kd[:, None], (dims.n, d)))
    if P.prior_tdiag is not None:
        emit(trn_col[:dims.num_trans], trn_col[:dims.num_trans],
             _np(P.prior_tdiag))

    if rows_all:
        return (np.concatenate(rows_all), np.concatenate(cols_all),
                np.concatenate(vals_all))
    return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))


def build_tiled(P: prob.ProblemData, dims: ProblemDims, T: int = 128,
                dtype=torch.float32,
                precond: Optional[prob.Preconditioner] = None,
                reg: float = 0.1, tile_precond=False,
                device=None, pack: Optional[str] = None) -> TiledProblem:
    """Host-side: RCM order, tile the scalar Q, invert the Jacobi blocks.

    `dtype` selects the tile precision (f32 for the fast phase, f64 for the
    refinement phase).  `precond` reuses an existing block-Jacobi
    factorization; otherwise one is built with regularization `reg`.
    `tile_precond` is False (per-pose Jacobi), True (diagonal-tile Jacobi)
    or "btd" (block-tridiagonal band factorization).  Tensors land on
    `device` (default: P's device).  `pack` selects the SpMM layout:
    "paired" also packs the stored upper tiles into two-row K-fused groups
    and compacts them (TiledQ.pairs) for the grouped kernel; anything else
    keeps the strip kernel alone.  None reads DCORA_SPMM_PACK.  The tile
    list and the strip CSR are kept either way.
    """
    if pack is None:
        pack = os.environ.get("DCORA_SPMM_PACK", "bucketed")
    device = P.device if device is None else device
    n, l, b, d = dims.n, dims.l, dims.b, dims.d
    dh = d + 1
    pose_rank, sph_rank, lmk_rank = _rcm_node_order(P, dims)

    def amax(a):
        return int(_np(a).max(initial=-1)) + 1

    n_aug_pose = max(n, amax(P.pp_ri), amax(P.pp_rj), amax(P.pl_ri))
    t_aug = max(dims.num_trans, amax(P.pp_ti), amax(P.pp_tj),
                amax(P.pl_ti), amax(P.pl_tj), amax(P.rg_ti), amax(P.rg_tj))
    l_aug = max(l, amax(P.rg_q))

    rot_base, trn_col, sph_col = scalar_maps(
        dims, pose_rank, sph_rank, lmk_rank, n_aug_pose, t_aug, l_aug)
    rows, cols, vals = scalar_coo(P, dims, rot_base, trn_col, sph_col)

    k = dh * n + l + b
    nt = max(-(-k // T), 1)
    kpad = nt * T

    # dense tiles straight from the raw COO with one bincount (duplicate
    # scalar entries accumulate in the bincount itself)
    tr = (rows // T).astype(np.int64)
    tc = (cols // T).astype(np.int64)
    keys, inv = np.unique(tr * nt + tc, return_inverse=True)
    trow = (keys // nt).astype(np.int64)
    tcol = (keys % nt).astype(np.int64)
    if len(keys):
        flat = inv * (T * T) + (rows - tr * T) * T + (cols - tc * T)
        dense = np.bincount(flat, weights=vals,
                            minlength=len(keys) * T * T
                            ).reshape(len(keys), T, T)
    else:
        dense = np.zeros((1, T, T))
        trow = np.zeros(1, np.int64)
        tcol = np.zeros(1, np.int64)

    # scalar ordering maps (RA ordering: rot (i,a) -> i*d + a, spheres,
    # then translations)
    fl_of_ra = np.empty(k, np.int64)
    fl_of_ra[:n * d] = pose_rank[np.arange(n * d) // d] * dh + \
        (np.arange(n * d) % d)
    if l:
        fl_of_ra[n * d:n * d + l] = n * dh + sph_rank
    fl_of_ra[n * d + l:n * d + l + n] = pose_rank * dh + d
    if b:
        fl_of_ra[n * d + l + n:] = n * dh + l + lmk_rank
    ra_of_fl = np.full(kpad, k, np.int64)
    ra_of_fl[fl_of_ra] = np.arange(k)

    # the stored upper triangle, sorted by (col, row)
    up = trow <= tcol
    order = np.lexsort((trow[up], tcol[up]))
    up_rows, up_cols = trow[up][order], tcol[up][order]
    up_tiles = dense[up][order]
    strips = build_output_csr(up_rows, up_cols, up_tiles, nt)

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), device=device,
                               dtype=dt)

    pairs = None
    if pack == "paired":
        np_dt = np.float32 if dtype == torch.float32 else np.float64
        pairs = to_device(compact_buckets(build_row_pairs_bucketed(
            up_rows, up_cols, up_tiles.astype(np_dt), T=T)), dtype, device)

    meta = TiledMeta(d=d, n=n, l=l, b=b, T=T, nt=nt)
    Q = TiledQ(
        tiles=dev(up_tiles, dtype),
        tile_rows=dev(up_rows, torch.int64),
        tile_cols=dev(up_cols, torch.int64),
        strips=to_device(strips, dtype, device),
        ra_of_fl=dev(ra_of_fl, torch.int64),
        fl_of_ra=dev(fl_of_ra, torch.int64),
        pairs=pairs,
    )

    # block-Jacobi preconditioner in flat (RCM) order
    if precond is not None:
        perm = np.argsort(pose_rank)  # original pose index at each RCM slot
        pose_inv = _np(precond.pose_inv)[perm]
        sph_d = _np(precond.sph_diag)
        lmk_d = _np(precond.lmk_diag)
        sph_inv = np.zeros(max(l, 0))
        lmk_inv = np.zeros(max(b, 0))
        if l:
            sph_inv[sph_rank] = 1.0 / np.where(sph_d == 0, 1.0, sph_d)
        if b:
            lmk_inv[lmk_rank] = 1.0 / np.where(lmk_d == 0, 1.0, lmk_d)
    else:
        # the diagonal (dh x dh) pose blocks straight from the raw COO
        pose_blocks = np.zeros((n, dh, dh))
        in_pose = (rows < n * dh) & (rows // dh == cols // dh)
        np.add.at(pose_blocks,
                  (rows[in_pose] // dh, rows[in_pose] % dh,
                   cols[in_pose] % dh),
                  vals[in_pose])
        pose_inv = np.linalg.inv(pose_blocks + reg * np.eye(dh))
        tail_diag = np.zeros(max(l + b, 1))
        on_tail = (rows >= n * dh) & (rows == cols)
        np.add.at(tail_diag, rows[on_tail] - n * dh, vals[on_tail])
        sph_inv = np.zeros(max(l, 0))
        lmk_inv = np.zeros(max(b, 0))
        if l:
            sd = tail_diag[:l] + reg
            sph_inv[:] = 1.0 / np.where(sd == 0, 1.0, sd)
        if b:
            ld = tail_diag[l:l + b] + reg
            lmk_inv[:] = 1.0 / np.where(ld == 0, 1.0, ld)
    diag_inv = btd_ltil = btd_sinv = None
    if tile_precond == "btd":
        Ltil, Sinv = _factor_btd(dense, trow, tcol, nt, T, reg)
        btd_ltil, btd_sinv = dev(Ltil, dtype), dev(Sinv, dtype)
    elif tile_precond:
        # invert the regularized T x T diagonal tiles (f64 inversion, stored
        # at the tile dtype); padding rows >= k get reg on the diagonal
        diag_blocks = np.zeros((nt, T, T))
        on_diag = trow == tcol
        diag_blocks[trow[on_diag]] = dense[on_diag]
        diag_blocks += reg * np.eye(T)
        diag_inv = dev(np.linalg.inv(diag_blocks), dtype)
    return TiledProblem(
        Q=Q, meta=meta, pose_inv=dev(pose_inv, dtype),
        sph_inv=dev(sph_inv, dtype), lmk_inv=dev(lmk_inv, dtype),
        diag_inv=diag_inv, btd_ltil=btd_ltil, btd_sinv=btd_sinv,
    )


def _factor_btd(dense, trow, tcol, nt: int, T: int, reg: float):
    """Block-LDL^T of the regularized block-tridiagonal part of Q.

    M = (I + L~) S (I + L~)^T with L~_i = L_i inv(S_{i-1}) and
    S_i = D_i + reg I - L_i inv(S_{i-1}) L_i^T.  Each Schur complement is
    safeguarded: if its smallest eigenvalue falls below 0.5*reg the block is
    shifted up to that floor.  Returns (L~ [nt,T,T] with L~_0 = 0,
    inv(S) [nt,T,T]) in float64 numpy.  ``dense`` holds ALL stored tiles
    (both triangles), as the JAX build does.
    """
    D = np.zeros((nt, T, T))
    on_diag = trow == tcol
    D[trow[on_diag]] = dense[on_diag]
    D += reg * np.eye(T)
    L = np.zeros((nt, T, T))  # L[i] = tile(i, i-1), i >= 1
    on_sub = trow == tcol + 1
    L[trow[on_sub]] = dense[on_sub]

    floor = 0.5 * reg
    Sinv = np.zeros((nt, T, T))
    Ltil = np.zeros((nt, T, T))
    Sprev_inv = None
    for i in range(nt):
        Si = D[i].copy()
        if i > 0 and L[i].any():
            Ltil[i] = L[i] @ Sprev_inv
            Si -= Ltil[i] @ L[i].T
        w = np.linalg.eigvalsh(0.5 * (Si + Si.T))
        if w[0] < floor:
            Si += (floor - w[0]) * np.eye(T)
        Sinv[i] = np.linalg.inv(0.5 * (Si + Si.T))
        Sprev_inv = Sinv[i]
    return Ltil, Sinv


# --------------------------------------------------------------------------
# Device ops
# --------------------------------------------------------------------------


def apply_tiled(TP: TiledProblem, Xf: torch.Tensor) -> torch.Tensor:
    """W = Xf Q (symmetric Q):  [r_pad, kpad] -> [r_pad, kpad], through the
    grouped kernel on the compacted paired packs when the build made them
    and the strip kernel otherwise (their plain versions on the CPU)."""
    Q = TP.Q
    X2 = Xf.reshape(Xf.shape[0], -1).contiguous()  # a stack: [r_pad, A kpad]
    if Q.pairs is not None:
        return spmm_paired(Q.pairs, X2).view(Xf.shape)
    return spmm_sym(Q.strips, X2).view(Xf.shape)


def to_flat(TP: TiledProblem, X: RAState, r_pad: Optional[int] = None
            ) -> torch.Tensor:
    """RAState -> flat [r_pad, kpad] (tiled ordering)."""
    ra = lifted.to_flat(X)  # [r, k]
    if r_pad is not None and r_pad > ra.shape[0]:
        ra = torch.nn.functional.pad(ra, (0, 0, 0, r_pad - ra.shape[0]))
    ra = torch.nn.functional.pad(ra, (0, 1))  # the zero column k
    return ra[:, TP.Q.ra_of_fl].contiguous()


def from_flat(TP: TiledProblem, Xf: torch.Tensor, r: Optional[int] = None
              ) -> RAState:
    """Flat [r_pad, kpad] -> RAState (optionally truncating rank rows)."""
    ra = Xf[:, TP.Q.fl_of_ra]
    if r is not None:
        ra = ra[:r]
    m = TP.meta
    return lifted.from_flat(ra, ProblemDims(m.d, m.n, m.l, m.b))


def _pose3(meta: TiledMeta, Xf: torch.Tensor) -> torch.Tensor:
    """[r, n, dh] view of the pose section (writes go through to Xf);
    [r, A, n, dh] of a stack."""
    return Xf[..., :meta.pose_end].view(*Xf.shape[:-1], meta.n, meta.dh)


def _sph(meta: TiledMeta, Xf: torch.Tensor) -> torch.Tensor:
    return Xf[..., meta.pose_end:meta.sph_end]


# The per-pose Riemannian ops.  On the card each is a launch of
# csrc/flat_ops.cu: flat_rhess (the projection, with the Weingarten term and
# the Gram of weingarten_setup) and flat_precond (the per-pose block-Jacobi
# solve and the projection in one pass).  Their plain versions below are
# the einsum code over the [r, n, dh] view; the CPU path and the tests run
# them, nothing on the card does.


def _sym_gram(meta: TiledMeta, Xf: torch.Tensor, Vf: torch.Tensor):
    """sym(Y_i^T V_i) per pose as [n, d, d] ([A, n, d, d] of a stack)."""
    d = meta.d
    S = torch.einsum("r...na,r...nb->...nab", _pose3(meta, Xf)[..., :d],
                     _pose3(meta, Vf)[..., :d])
    return 0.5 * (S + S.transpose(-1, -2))


def _tangent_project_plain(meta: TiledMeta, Xf: torch.Tensor,
                           Vf: torch.Tensor) -> torch.Tensor:
    """V - Y sym(Y^T V) on Stiefel blocks; sphere de-projection; id on R."""
    d = meta.d
    out = Vf.clone()
    _pose3(meta, out)[..., :d] -= torch.einsum(
        "r...nb,...nba->r...na", _pose3(meta, Xf)[..., :d],
        _sym_gram(meta, Xf, Vf))
    if meta.l:
        Xs, Vs = _sph(meta, Xf), _sph(meta, Vf)
        _sph(meta, out)[:] = Vs - Xs * (Xs * Vs).sum(0, keepdim=True)
    return out


def _weingarten_setup_plain(meta: TiledMeta, Xf: torch.Tensor,
                            egrad: torch.Tensor):
    s_inner = (_sph(meta, Xf) * _sph(meta, egrad)).sum(0, keepdim=True)
    return _sym_gram(meta, Xf, egrad), s_inner


def weingarten_apply(meta: TiledMeta, eta: torch.Tensor, aux
                     ) -> torch.Tensor:
    """Apply the precomputed Weingarten constants to a tangent vector (the
    plain version: on the card flat_rhess applies them)."""
    Ssym, s_inner = aux
    d = meta.d
    out = torch.zeros_like(eta)
    _pose3(meta, out)[..., :d] = torch.einsum(
        "r...nb,...nab->r...na", _pose3(meta, eta)[..., :d], Ssym)
    if meta.l:
        _sph(meta, out)[:] = _sph(meta, eta) * s_inner
    return out


def _rhess_plain(meta: TiledMeta, Xf, HV, eta, aux, project=True):
    H = HV if eta is None else HV - weingarten_apply(meta, eta, aux)
    return _tangent_project_plain(meta, Xf, H) if project else H


_FLAT_ARGS = ctypes.c_int64 * 19  # csrc/flat_ops.cu's FlatArgs


def _check_flat(name: str, meta: TiledMeta, *arrays):
    """The flat operands a kernel of flat_ops.cu takes: one float dtype,
    [r_pad, kpad] or a stack's [r_pad, A, kpad] alike, contiguous, on one
    CPU or CUDA device; d at most 3 and the sections inside kpad.  None
    entries are absent operands."""
    first = next(a for a in arrays if a is not None)
    if not 1 <= meta.d <= 3 or meta.sph_end + meta.b > meta.kpad:
        raise ValueError(f"{name}: layout d={meta.d}, k={meta.k}, "
                         f"kpad={meta.kpad} is not one the kernel takes")
    if first.dim() not in (2, 3) or first.shape[-1] != meta.kpad or \
            first.shape[0] < 1:
        raise ValueError(f"{name}: shape {tuple(first.shape)} is not "
                         f"[r_pad, kpad] or [r_pad, A, kpad] with kpad "
                         f"{meta.kpad}")
    for a in arrays:
        if a is None:
            continue
        if a.dtype not in (torch.float32, torch.float64) or \
                a.dtype != first.dtype:
            raise TypeError(f"{name}: operands {a.dtype} and {first.dtype} "
                            "must share float32 or float64")
        if a.shape != first.shape:
            raise ValueError(f"{name}: shapes {tuple(a.shape)} and "
                             f"{tuple(first.shape)} differ")
        if not a.is_contiguous():
            raise ValueError(f"{name}: an operand is not contiguous")
        if a.device != first.device:
            raise ValueError(f"{name}: operands on {a.device} and "
                             f"{first.device}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")
    return first


def _check_leaf(name: str, what: str, a: torch.Tensor, like: torch.Tensor,
                shape: tuple):
    """A per-pose / per-column constant: the flat operand's dtype and
    device, the given shape, contiguous."""
    if a.dtype != like.dtype:
        raise TypeError(f"{name}: {what} is {a.dtype}, the operands "
                        f"{like.dtype}")
    if tuple(a.shape) != shape or not a.is_contiguous() or \
            a.device != like.device:
        raise ValueError(f"{name}: {what} is {tuple(a.shape)} on "
                         f"{a.device}, not a contiguous {shape} on "
                         f"{like.device}")


def _lead(X: torch.Tensor) -> tuple:
    """() for one problem, (A,) for a stack."""
    return tuple(X.shape[1:-1])


def _launch_flat(kernel: str, X: torch.Tensor, args):
    fn = kernels.entry("flat_ops", X.dtype, kernel)
    desc = _FLAT_ARGS(*args)  # alive until the call has read it
    if X.device.index == torch.cuda.current_device():
        err = fn(ctypes.addressof(desc), kernels.stream(X))
    else:
        with torch.cuda.device(X.device):
            err = fn(ctypes.addressof(desc), kernels.stream(X))
    kernels.check_launch(kernel, err)


def _ptr(a: Optional[torch.Tensor]) -> int:
    return 0 if a is None else a.data_ptr()


def _sizes(meta: TiledMeta, X: torch.Tensor, project: bool = True):
    return (meta.n, meta.l, meta.b, meta.d, meta.kpad,
            X.shape[1] if X.dim() == 3 else 1, X.shape[0], int(project))


@kernels.counted
def flat_rhess(meta: TiledMeta, Xf: Optional[torch.Tensor],
               HV: torch.Tensor, eta: Optional[torch.Tensor] = None,
               aux=None, project: bool = True) -> torch.Tensor:
    """P_X(HV - W(eta)) in one pass: the Riemannian Hessian of the flat
    tCG from HV = apply_tiled(TP, eta) and weingarten_setup's aux =
    (Ssym, s_inner); eta None is tangent_project_flat (no Weingarten term);
    project False leaves out the projection (Xf may then be None) and
    returns HV - W(eta).  A CUDA HV launches csrc/flat_ops.cu's flat_rhess
    or raises; a CPU HV runs the plain version."""
    first = _check_flat("flat_rhess", meta, Xf, HV, eta)
    if project and Xf is None:
        raise ValueError("flat_rhess: the projection needs X")
    if eta is not None:
        Ssym, s_inner = aux
        lead = _lead(first)
        _check_leaf("flat_rhess", "Ssym", Ssym, first,
                    lead + (meta.n, meta.d, meta.d))
        _check_leaf("flat_rhess", "s_inner", s_inner, first,
                    (1,) + lead + (meta.l,))
    if first.device.type == "cpu":
        return _rhess_plain(meta, Xf, HV, eta, aux, project)
    out = torch.empty_like(HV)
    Ssym, s_inner = aux if eta is not None else (None, None)
    _launch_flat("flat_rhess", first, (
        _ptr(Xf), HV.data_ptr(), _ptr(eta), _ptr(Ssym), _ptr(s_inner),
        0, 0, 0, out.data_ptr(), 0, 0, *_sizes(meta, first, project)))
    kernels.count_launch(flat_rhess)
    return out


def tangent_project_flat(meta: TiledMeta, Xf: torch.Tensor,
                         Vf: torch.Tensor) -> torch.Tensor:
    """V - Y sym(Y^T V) on Stiefel blocks; sphere de-projection; id on R
    (flat-layout manifold.tangent_project): flat_rhess without the
    Weingarten term."""
    return flat_rhess(meta, Xf, Vf)


def weingarten_setup(meta: TiledMeta, Xf: torch.Tensor, egrad: torch.Tensor):
    """Constants of the Weingarten map for a fixed egrad: sym(Y^T egrad)
    [n, d, d] and the sphere inner products [1, l] ([A, n, d, d] and [1,
    A, l] of a stack; l may be 0).  egrad is fixed during a tCG solve, so
    this runs once per outer iteration.  On the card it is one launch of
    flat_rhess that writes the Grams and no projection."""
    first = _check_flat("weingarten_setup", meta, Xf, egrad)
    if first.device.type == "cpu":
        return _weingarten_setup_plain(meta, Xf, egrad)
    lead = _lead(first)
    Ssym = torch.empty(lead + (meta.n, meta.d, meta.d), dtype=first.dtype,
                       device=first.device)
    s_inner = torch.empty((1,) + lead + (meta.l,), dtype=first.dtype,
                          device=first.device)
    _launch_flat("flat_rhess", first, (
        Xf.data_ptr(), egrad.data_ptr(), 0, 0, 0, 0, 0, 0, 0,
        Ssym.data_ptr(), _ptr(s_inner) if meta.l else 0,
        *_sizes(meta, first)))
    kernels.count_launch(flat_rhess)
    return Ssym, s_inner


def _jacobi(TP: TiledProblem, dtype: torch.dtype):
    """(pose_inv, sph_inv, lmk_inv) at `dtype`, contiguous, made once per
    dtype and kept on TP."""
    got = TP.jacobi.get(dtype)
    if got is None:
        got = TP.jacobi[dtype] = tuple(
            a.to(dtype).contiguous()
            for a in (TP.pose_inv, TP.sph_inv, TP.lmk_inv))
    return got


def _precondition_pose_plain(TP: TiledProblem, Vf: torch.Tensor
                             ) -> torch.Tensor:
    """The per-pose (dh x dh) block-Jacobi solve: the plain version."""
    meta = TP.meta
    pose_inv, sph_inv, lmk_inv = _jacobi(TP, Vf.dtype)
    out = Vf.clone()
    _pose3(meta, out)[:] = torch.einsum(
        "r...nc,...nce->r...ne", _pose3(meta, Vf), pose_inv)
    if meta.l:
        _sph(meta, out)[:] = _sph(meta, Vf) * sph_inv
    if meta.b:
        lm = out[..., meta.sph_end:meta.sph_end + meta.b]
        lm *= lmk_inv
    return out


@kernels.counted
def flat_precond(TP: TiledProblem, Xf: torch.Tensor,
                 Vf: torch.Tensor) -> torch.Tensor:
    """P_X(M^{-1} V) for the per-pose block-Jacobi preconditioner in one
    pass.  The inverses must have V's dtype (the tile dtype) and device.  A
    CUDA V launches csrc/flat_ops.cu's flat_precond or raises; a CPU V runs
    the plain version."""
    meta = TP.meta
    first = _check_flat("flat_precond", meta, Xf, Vf)
    if TP.pose_inv.dtype != first.dtype:
        raise TypeError(f"flat_precond: V is {first.dtype}, the "
                        f"preconditioner {TP.pose_inv.dtype}")
    pose_inv, sph_inv, lmk_inv = _jacobi(TP, first.dtype)
    lead = _lead(first)
    _check_leaf("flat_precond", "pose_inv", pose_inv, first,
                lead + (meta.n, meta.dh, meta.dh))
    _check_leaf("flat_precond", "sph_inv", sph_inv, first, lead + (meta.l,))
    _check_leaf("flat_precond", "lmk_inv", lmk_inv, first, lead + (meta.b,))
    if first.device.type == "cpu":
        return _tangent_project_plain(meta, Xf,
                                      _precondition_pose_plain(TP, Vf))
    out = torch.empty_like(Vf)
    _launch_flat("flat_precond", first, (
        Xf.data_ptr(), Vf.data_ptr(), 0, 0, 0, pose_inv.data_ptr(),
        _ptr(sph_inv), _ptr(lmk_inv), out.data_ptr(), 0, 0,
        *_sizes(meta, first)))
    kernels.count_launch(flat_precond)
    return out


def _precondition_tiles(TP: TiledProblem, Vf: torch.Tensor) -> torch.Tensor:
    """Tile-granularity block-Jacobi: one batched [nt, T, T] product."""
    meta = TP.meta
    V3 = Vf.reshape(*Vf.shape[:-1], meta.nt, meta.T)
    W = torch.einsum("r...ct,...cts->r...cs", V3, TP.diag_inv.to(Vf.dtype))
    return W.reshape(Vf.shape).contiguous()  # a stack's comes permuted


def _precondition_btd(TP: TiledProblem, Vf: torch.Tensor) -> torch.Tensor:
    """Block-tridiagonal solve M^{-1} v along the RCM band.

    Row-vector form of the block-LDL^T solve (see _factor_btd): forward
    substitution u_i = v_i - u_{i-1} L~_i^T, batched diagonal solve
    w_i = u_i Sinv_i, backward substitution y_i = w_i - y_{i+1} L~_{i+1}.
    """
    meta = TP.meta
    r_pad = Vf.shape[0]
    V3 = Vf.reshape(r_pad, meta.nt, meta.T).transpose(0, 1)  # [nt, r, T]
    Ltil = TP.btd_ltil.to(Vf.dtype)
    Sinv = TP.btd_sinv.to(Vf.dtype)
    U = torch.empty_like(V3)
    u = torch.zeros_like(V3[0])
    for i in range(meta.nt):
        u = V3[i] - u @ Ltil[i].T
        U[i] = u
    Wd = torch.bmm(U, Sinv)
    Y = torch.empty_like(Wd)
    y = torch.zeros_like(Wd[0])
    for i in range(meta.nt - 1, -1, -1):
        y = Wd[i] - (y @ Ltil[i + 1] if i + 1 < meta.nt else 0.0)
        Y[i] = y
    return Y.transpose(0, 1).reshape(r_pad, meta.kpad)


# CTAs per thread-block cluster of csrc/btd_solve.cu (its kCluster): each
# owns 128 / 8 of a step's output columns (PERF.md: 1-16 timed on the
# H100; 16, not portable, was 5-12 % faster)
BTD_CLUSTER = 8
_BTD_ROWS = 8  # rows of V per cluster


def _check_btd(TP: TiledProblem, Vf: torch.Tensor):
    if TP.btd_ltil is None:
        raise ValueError("btd_solve: the TiledProblem has no BTD factor")
    if Vf.dtype not in (torch.float32, torch.float64) or \
            Vf.dtype != TP.btd_ltil.dtype:
        raise TypeError(f"btd_solve: V is {Vf.dtype}, the factors "
                        f"{TP.btd_ltil.dtype} (float32 or float64, alike)")
    if Vf.dim() != 2 or Vf.shape[1] != TP.meta.kpad:
        raise ValueError(f"btd_solve: V is {tuple(Vf.shape)}, not "
                         f"[r_pad, {TP.meta.kpad}]")
    if Vf.shape[0] < _BTD_ROWS or Vf.shape[0] % _BTD_ROWS:
        raise ValueError(f"btd_solve: r_pad {Vf.shape[0]} is not a "
                         f"positive multiple of {_BTD_ROWS}")
    if not Vf.is_contiguous():
        raise ValueError("btd_solve: V is not contiguous")
    if Vf.device != TP.btd_ltil.device:
        raise ValueError(f"btd_solve: V on {Vf.device}, the factors on "
                         f"{TP.btd_ltil.device}")


def _btd_layout(TP: TiledProblem):
    """L~^T, inv(S) and L~ (the B of the forward, diagonal and backward
    products) laid out panel by panel for the kernel's cluster: [nt,
    BTD_CLUSTER, T, T / BTD_CLUSTER], panel j of block i = B_i[:, j W:(j+1)
    W], so each CTA's panel is contiguous.  Made once per TiledProblem
    (three factors' memory)."""
    if TP.btd_layout is None:
        nt, T, C = TP.meta.nt, TP.meta.T, BTD_CLUSTER
        TP.btd_layout = tuple(
            B.reshape(nt, T, C, T // C).transpose(1, 2).contiguous()
            for B in (TP.btd_ltil.transpose(1, 2), TP.btd_sinv,
                      TP.btd_ltil))
    return TP.btd_layout


@kernels.counted
def btd_solve(TP: TiledProblem, Vf: torch.Tensor) -> torch.Tensor:
    """M^{-1} v of the block-tridiagonal preconditioner: V [r_pad, kpad]
    (r_pad a multiple of 8, contiguous, the factors' dtype and device) ->
    a new [r_pad, kpad].  A CUDA V launches csrc/btd_solve.cu once (a
    cluster of BTD_CLUSTER CTAs per 8 rows) or raises; a CPU V runs the
    plain loop _precondition_btd."""
    _check_btd(TP, Vf)
    if Vf.device.type == "cpu":
        return _precondition_btd(TP, Vf)
    if TP.meta.T != 128:
        raise ValueError(f"btd_solve: the kernel takes 128-wide tiles, not "
                         f"{TP.meta.T}")
    factors = _btd_layout(TP)
    fn = kernels.entry("btd_solve", Vf.dtype)
    Y = torch.empty_like(Vf)
    with torch.cuda.device(Vf.device):
        kernels.check_launch("btd_solve", fn(
            *(f.data_ptr() for f in factors), Vf.data_ptr(), Y.data_ptr(),
            TP.meta.nt, Vf.shape[0], kernels.stream(Vf)))
    kernels.count_launch(btd_solve)
    return Y


def precondition_flat(TP: TiledProblem, Vf: torch.Tensor) -> torch.Tensor:
    """Block-Jacobi solve in flat layout (cf. prob.apply_preconditioner):
    block-tridiagonal with TP.btd_ltil (btd_solve: its kernel on the card,
    the plain loop on the CPU), tile-granularity with TP.diag_inv, per-pose
    (dh x dh) blocks otherwise (the plain version; the tCG takes it fused
    with the projection, flat_precond)."""
    if TP.btd_ltil is not None:
        return btd_solve(TP, Vf)
    if TP.diag_inv is not None:
        return _precondition_tiles(TP, Vf)
    return _precondition_pose_plain(TP, Vf)


def precond_project(TP: TiledProblem, Xf: torch.Tensor,
                    Vf: torch.Tensor) -> torch.Tensor:
    """P_X(M^{-1} V), the tCG's preconditioner: per-pose block-Jacobi
    fused with the projection (flat_precond); the BTD or the tile solve
    (precondition_flat), then the projection (flat_rhess)."""
    if TP.btd_ltil is None and TP.diag_inv is None:
        return flat_precond(TP, Xf, Vf)
    return tangent_project_flat(TP.meta, Xf, precondition_flat(TP, Vf))


def retract_flat(meta: TiledMeta, Xf: torch.Tensor,
                 Vf: torch.Tensor) -> torch.Tensor:
    """Polar retraction on Stiefel blocks, normalize spheres, add elsewhere."""
    d = meta.d
    out = Xf + Vf
    A = _pose3(meta, out)[..., :d]                         # [r, n, d]
    Gm = torch.einsum("r...na,r...nb->...nab", A, A)      # [n, d, d]
    _pose3(meta, out)[..., :d] = torch.einsum("r...nb,...nba->r...na", A,
                                              inv_sqrt_psd(Gm))
    if meta.l:
        S = _sph(meta, out)
        nrm = torch.linalg.vector_norm(S, dim=0, keepdim=True)
        _sph(meta, out)[:] = S / torch.where(nrm == 0, torch.ones_like(nrm),
                                             nrm)
    return out


def cost_flat(TP: TiledProblem, Xf: torch.Tensor,
              Gf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f = 0.5 <Xf Q, Xf> + <Xf, Gf>."""
    f = 0.5 * torch.sum(apply_tiled(TP, Xf) * Xf)
    if Gf is not None:
        f = f + torch.sum(Xf * Gf)
    return f


def egrad_flat(TP: TiledProblem, Xf: torch.Tensor,
               Gf: Optional[torch.Tensor] = None) -> torch.Tensor:
    W = apply_tiled(TP, Xf)
    return W if Gf is None else W + Gf
