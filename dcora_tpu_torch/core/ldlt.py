"""Supernodal LDL^T of the certificate S + tI: the inertia proof of
certification on the card.

The proof factors S + tI = P^T L D L^T P with diagonal pivots only and
reads the signs of D (Sylvester's law: they are S + tI's inertia, whatever
the ordering), the same mathematics as SuperLU with diag_pivot_thresh=0
(``certify.ldl_psd_proof``), which the CPU path keeps.

* :func:`analyse` (host, once per S): the variable graph (one node per
  pose, sphere or landmark, standing for its scalar columns of S in RA
  ordering), its approximate-minimum-degree ordering and supernodal
  symbolic factorization (``native/src/ldlt_analyse.cpp``), expanded to
  scalar columns so that each node's columns stay adjacent; the frontal
  matrices' offsets, the maps that scatter S's CSR values and the
  children's update matrices into them, and the schedule: the supernodal
  tree level by level from the leaves, per level one assembly launch,
  then per panel of NB columns one panel launch and one update launch.
* :func:`factor_plain`: the same multifrontal factorization in plain
  PyTorch, front by front, on CPU tensors: the kernel's reference.
* :class:`DeviceFactor`: the maps on the card and ``csrc/ldlt.cu`` run
  over the schedule in one C call; the pivots stay on the card.
* :class:`ShiftedProof`: ``prove(t)`` on the card for many shifts of one
  S, the analysis and the upload of S's values done once.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from dcora_tpu_torch import native
from dcora_tpu_torch.core import kernels
from dcora_tpu_torch.types import ProblemDims
from dcora_tpu_torch.utils.timing import count, span

# Compiled into csrc/ldlt.cu: panel width, update tile edge, rows of a
# panel CTA, columns of an assembly CTA.
NB, TILE, ROWS, ACOLS = 32, 64, 128, 32
ASSEMBLE, PANEL, UPDATE = 0, 1, 2


def node_columns(dims: ProblemDims):
    """(ptr, cols): the scalar columns of S in RA ordering of each node of
    the variable graph, node v owning cols[ptr[v]:ptr[v + 1]]: pose i its
    d rotation columns and its translation column, then one node per
    sphere and per landmark."""
    n, d, l, b = dims.n, dims.d, dims.l, dims.b  # noqa: E741
    pose = np.concatenate([np.arange(n)[:, None] * d + np.arange(d),
                           (n * d + l + np.arange(n))[:, None]], axis=1)
    cols = np.concatenate([pose.ravel(), n * d + np.arange(l),
                           n * d + l + n + np.arange(b)])
    ptr = np.concatenate([np.arange(n + 1) * (d + 1),
                          n * (d + 1) + 1 + np.arange(l + b)])
    return ptr.astype(np.int64), cols.astype(np.int64)


class Analysis(NamedTuple):
    """Symbolic LDL^T of one pattern; positions are columns of the
    permuted matrix, supernodes in postorder (children first)."""

    k: int
    nnz: int  # S's stored entries, whose CSR values the maps index
    perm: np.ndarray  # [k] the column of S placed at each position
    first: np.ndarray  # [ns] first position of each supernode
    width: np.ndarray  # [ns] its columns
    size: np.ndarray  # [ns] its front's edge: width + rows below
    parent: np.ndarray  # [ns] -1 at a root
    level: np.ndarray  # [ns] height above the leaves
    rows_ptr: np.ndarray  # [ns + 1]
    rows: np.ndarray  # positions below each supernode, ascending
    rel: np.ndarray  # rows' places in the parent's front (-1 at a root)
    off: np.ndarray  # [ns] fronts' offsets (column-major f x f each)
    child_ptr: np.ndarray  # [ns + 1]
    child: np.ndarray  # children of each supernode, ascending
    amap_ptr: np.ndarray  # [k + 1] per position, S's lower entries
    amap_src: np.ndarray  # their index in S.data
    amap_dst: np.ndarray  # their offset in the front (col * f + row)
    jobs: np.ndarray  # [J, 4] int32: supernode, p0, pb, first tile
    launches: np.ndarray  # [L, 4] int64: kind, first job, jobs, tiles

    @property
    def front_words(self) -> int:
        """Length of the fronts' storage, in words."""
        return int((self.off + self.size.astype(np.int64) ** 2).max(
            initial=0))

    @property
    def nnz_L(self) -> int:
        """Entries of L's supernodal panels (diagonal included)."""
        w, m = self.width, self.size - self.width
        return int((w * (w + 1) // 2 + w * m).sum())


def _segments(lengths):
    """(owner, offset in owner) of each element of consecutive segments."""
    lengths = np.asarray(lengths, np.int64)
    owner = np.repeat(np.arange(len(lengths)), lengths)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return owner, np.arange(int(lengths.sum())) - starts[owner]


def analyse(S, dims: ProblemDims) -> Analysis:
    """Ordering, supernodal symbolic factorization, scatter maps and
    schedule of the LDL^T of S's pattern (scipy sparse, k x k, the RA
    ordering of `dims`)."""
    import scipy.sparse as sp

    count("ldlt.analyses")
    S = S.tocsr()
    if not S.has_canonical_format:  # the maps place each entry once
        raise ValueError("ldlt.analyse: S has duplicate or unsorted entries")
    k = S.shape[0]
    nptr, ncols = node_columns(dims)
    nn = len(nptr) - 1
    weight = np.diff(nptr)
    node_of = np.empty(k, np.int64)
    node_of[ncols] = np.repeat(np.arange(nn), weight)
    rows = np.repeat(np.arange(k), np.diff(S.indptr))
    cols = S.indices.astype(np.int64)
    a, b = node_of[rows], node_of[cols]
    off_diag = a != b
    G = sp.coo_matrix((np.ones(int(off_diag.sum())),
                       (a[off_diag], b[off_diag])), shape=(nn, nn)).tocsr()
    G = (G + G.T).tocsr()
    res = native.ldlt_analyse(G.indptr, G.indices, weight)
    if res is None:
        raise RuntimeError("the LDL^T analysis needs the native library: "
                           f"{native.build_error}")
    nperm, sn_ptr, parent, level, nrs_ptr, nrs = res

    # nodes -> scalar positions: node nperm[v] takes positions
    # cstart[v] .. cstart[v] + wt[v] - 1
    wt = weight[nperm]
    cstart = np.concatenate([[0], np.cumsum(wt)])
    owner, within = _segments(wt)
    perm = ncols[nptr[nperm][owner] + within]
    pinv = np.empty(k, np.int64)
    pinv[perm] = np.arange(k)
    first = cstart[sn_ptr[:-1]]
    width = cstart[sn_ptr[1:]] - first
    ns = len(first)
    # scalar rows below each supernode: its row nodes' columns
    rcount = np.bincount(np.repeat(np.arange(ns), np.diff(nrs_ptr)),
                         weights=wt[nrs], minlength=ns).astype(np.int64)
    rows_ptr = np.concatenate([[0], np.cumsum(rcount)])
    rowner, rwithin = _segments(wt[nrs])
    srows = cstart[nrs][rowner] + rwithin
    size = width + rcount
    if size.max(initial=0) > 46340:
        raise ValueError(f"LDL^T front of {size.max()} columns: its "
                         "offsets overflow 32 bits")
    sn_of = np.repeat(np.arange(ns), width)
    row_sn = np.repeat(np.arange(ns), rcount)
    keys = row_sn * k + srows  # ascending

    def local(s, pos):
        """Place of position pos in supernode s's front."""
        inside = pos < first[s] + width[s]
        at = np.searchsorted(keys, s * k + pos)
        return np.where(inside, pos - first[s],
                        width[s] + at - rows_ptr[s])

    # each supernode's rows placed in its parent's front
    psn = parent[row_sn]
    rel = np.where(psn >= 0, local(np.maximum(psn, 0), srows), -1)
    # S's lower entries (in the permuted order) into the fronts
    pr, pc = pinv[rows], pinv[cols]
    low = np.nonzero(pr >= pc)[0]
    pr, pc = pr[low], pc[low]
    s_of = sn_of[pc]
    dst = (pc - first[s_of]) * size[s_of] + local(s_of, pr)
    order = np.argsort(pc, kind="stable")
    amap_src, amap_dst = low[order], dst[order]
    amap_ptr = np.concatenate([[0], np.cumsum(np.bincount(pc, minlength=k))])
    off = _front_offsets(size, level, parent)
    has = parent >= 0
    corder = np.argsort(parent[has], kind="stable")
    child = np.arange(ns)[has][corder]
    child_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(parent[has], minlength=ns))])
    jobs, launches = _schedule(width, size, level)
    return Analysis(k, S.nnz, perm, first, width, size, parent, level,
                    rows_ptr, srows, rel, off, child_ptr, child, amap_ptr,
                    amap_src, amap_dst, jobs, launches)


def _front_offsets(size, level, parent):
    """Offsets of the fronts in one buffer.  A front lives from its
    level's assembly to its parent's (a root to the end), so the fronts
    are grouped by (level, parent's level), and each group is placed
    first-fit beside the groups whose lives overlap its own, largest first
    within a level (native.ldlt_place; grid3D: 0.32 GB where one front
    after the other would take 0.91)."""
    words = size.astype(np.int64) ** 2
    top = int(level.max(initial=0)) + 1
    until = np.where(parent >= 0, level[np.maximum(parent, 0)], top)
    key = level * (top + 1) + until
    groups, grp = np.unique(key, return_inverse=True)
    gsize = np.bincount(grp, weights=words, minlength=len(groups)) \
        .astype(np.int64)
    gfrom, guntil = groups // (top + 1), groups % (top + 1)
    goff = native.ldlt_place(np.lexsort((-gsize, gfrom)), gsize, gfrom,
                             guntil)
    if goff is None:
        raise RuntimeError("the LDL^T analysis needs the native library: "
                           f"{native.build_error}")
    order = np.argsort(grp, kind="stable")
    within = np.empty(len(size), np.int64)
    within[order] = np.cumsum(words[order]) - words[order] \
        - np.repeat(np.concatenate([[0], np.cumsum(gsize)[:-1]]),
                    np.bincount(grp, minlength=len(groups)))
    return goff[grp] + within


def _schedule(width, size, level):
    """Jobs (supernode, p0, pb, first tile) and launches (kind, first job,
    jobs, tiles): level by level from the leaves, an assembly launch, then
    for each panel of NB columns a panel launch and an update launch over
    every front of the level that still has that panel."""
    ns = len(width)
    steps = -(-width // NB)
    smax = int(steps.max(initial=1))
    s, q = _segments(steps)
    p0 = q * NB
    pb = np.minimum(NB, width[s] - p0)
    trail = size[s] - p0 - pb
    nt = -(-trail // TILE)
    kinds = [
        (np.arange(ns), np.zeros(ns, np.int64), np.zeros(ns, np.int64),
         -(-size // ACOLS), level * (2 * smax + 1)),
        (s, p0, pb, np.maximum(1, -(-trail // ROWS)),
         level[s] * (2 * smax + 1) + 1 + 2 * q),
    ]
    u = trail > 0
    kinds.append((s[u], p0[u], pb[u], nt[u] * (nt[u] + 1) // 2,
                  level[s[u]] * (2 * smax + 1) + 2 + 2 * q[u]))
    js, jp0, jpb, jt, key = (np.concatenate(x) for x in zip(*kinds))
    order = np.lexsort((js, key))
    js, jp0, jpb, jt, key = js[order], jp0[order], jpb[order], jt[order], \
        key[order]
    ukeys, jfirst, njobs = np.unique(key, return_index=True,
                                     return_counts=True)
    grp = np.repeat(np.arange(len(ukeys)), njobs)
    csum = np.cumsum(jt)
    base = (csum - jt)[jfirst]  # tiles before each launch
    tile0 = csum - jt - base[grp]
    ntiles = csum[jfirst + njobs - 1] - base
    kind = np.where(ukeys % (2 * smax + 1) == 0, ASSEMBLE,
                    np.where(ukeys % (2 * smax + 1) % 2 == 1, PANEL, UPDATE))
    jobs = np.stack([js, jp0, jpb, tile0], axis=1).astype(np.int32)
    launches = np.stack([kind, jfirst, njobs, ntiles], axis=1) \
        .astype(np.int64)
    return np.ascontiguousarray(jobs), np.ascontiguousarray(launches)


# --------------------------------------------------------------------------
# Plain PyTorch factorization (CPU tensors)
# --------------------------------------------------------------------------


def _dense_ldlt_plain(A: torch.Tensor, w: int, piv: torch.Tensor):
    """Blocked right-looking LDL^T of A's first w columns in place (lower
    triangle read; diagonal pivots only; L below the diagonal, D on it),
    the update of A[w:, w:] left in place: per panel of NB columns, the
    unblocked factor of its diagonal block, the rows below solved against
    it, then the trailing update."""
    f = A.shape[0]
    for p0 in range(0, w, NB):
        e = min(w, p0 + NB)
        pb = e - p0
        B = A[p0:e, p0:e].clone()
        for j in range(pb):
            B[j + 1:, j + 1:] -= torch.outer(B[j + 1:, j] / B[j, j],
                                             B[j + 1:, j])
            B[j + 1:, j] /= B[j, j]
        d = B.diagonal().clone()
        piv[p0:e] = d
        A[p0:e, p0:e] = torch.tril(B)
        if e < f:
            L11 = torch.tril(B, -1) + torch.eye(pb, dtype=A.dtype)
            X = torch.linalg.solve_triangular(L11, A[e:, p0:e].T,
                                              upper=False,
                                              unitriangular=True).T
            L21 = X / d
            A[e:, p0:e] = L21
            A[e:, e:] -= (L21 * d) @ L21.T


def factor_plain(an: Analysis, values: torch.Tensor, shift: float,
                 panels: Optional[dict] = None) -> torch.Tensor:
    """Pivots [k] (permuted order) of S + shift*I, S's CSR values given,
    front by front in postorder: assembly (S's entries, the shift, then
    the children's update matrices in order), then the dense LDL^T.
    Given a dict `panels`, each supernode's [f, w] panel of L (D on its
    diagonal, its rows the supernode's columns then its rows below) is
    kept there under its index."""
    values = values.to(torch.float64)
    piv = torch.empty(an.k, dtype=torch.float64)
    fronts = {}
    for s in range(len(an.first)):
        f, w, c0 = int(an.size[s]), int(an.width[s]), int(an.first[s])
        F = torch.zeros(f * f, dtype=torch.float64)
        a0, a1 = int(an.amap_ptr[c0]), int(an.amap_ptr[c0 + w])
        F[torch.as_tensor(an.amap_dst[a0:a1])] = \
            values[torch.as_tensor(an.amap_src[a0:a1])]
        F[torch.arange(w) * (f + 1)] += shift
        A = F.view(f, f).T  # A[row, col] = F[col * f + row]
        for c in an.child[an.child_ptr[s]:an.child_ptr[s + 1]]:
            fc, wc = int(an.size[c]), int(an.width[c])
            U = fronts.pop(int(c)).view(fc, fc).T[wc:, wc:]
            rel = torch.as_tensor(an.rel[an.rows_ptr[c]:an.rows_ptr[c + 1]])
            ii, jj = torch.tril_indices(fc - wc, fc - wc)
            A.index_put_((rel[ii], rel[jj]), U[ii, jj], accumulate=True)
        _dense_ldlt_plain(A, w, piv[c0:c0 + w])
        if panels is not None:
            panels[s] = torch.tril(A[:, :w]).clone()
        if an.parent[s] >= 0:
            fronts[s] = F
    return piv


# --------------------------------------------------------------------------
# The kernel (csrc/ldlt.cu)
# --------------------------------------------------------------------------


@kernels.counted
def ldlt(plan: "DeviceFactor", values: torch.Tensor, shift: float):
    """Factor S + shift*I on the card over the plan's schedule (one C call,
    its launches counted), the pivots into plan.piv."""
    if values.dtype != torch.float64 or values.device != plan.device \
            or not values.is_contiguous() or values.shape != (plan.an.nnz,):
        raise ValueError(f"ldlt: S's {plan.an.nnz} values must be "
                         f"contiguous float64 on {plan.device}")
    ptrs = np.array([values.data_ptr(), plan.fronts.data_ptr(),
                     plan.piv.data_ptr()]
                    + [t.data_ptr() for t in plan.index], np.int64)
    fn = kernels.entry("ldlt", torch.float64, "ldlt_factor")
    kernels.check_launch("ldlt", fn(
        ctypes.c_void_p(ptrs.ctypes.data),
        ctypes.c_void_p(plan.launches.ctypes.data),
        len(plan.launches), float(shift),
        ctypes.c_void_p(kernels.stream(values))))
    ldlt.launches += len(plan.launches)


class DeviceFactor:
    """An analysis' maps and schedule on a CUDA device, with its fronts'
    storage and the pivots."""

    def __init__(self, an: Analysis, device):
        self.an = an
        self.piv = torch.empty(an.k, dtype=torch.float64, device=device)
        self.device = self.piv.device  # with its index

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=self.device)

        # the order of csrc/ldlt.cu's Plan, after values, fronts and piv
        self.index = [
            torch.as_tensor(an.off, device=self.device),
            i32(an.first), i32(an.width), i32(an.size),
            i32(an.child_ptr), i32(an.child), i32(an.rows_ptr),
            i32(an.rel), i32(an.amap_ptr), i32(an.amap_src),
            i32(an.amap_dst), i32(an.jobs),
        ]
        self.launches = np.ascontiguousarray(an.launches, np.int64)
        self.fronts = torch.empty(an.front_words, dtype=torch.float64,
                                  device=self.device)

    def factor(self, values: torch.Tensor, shift: float) -> torch.Tensor:
        ldlt(self, values, shift)
        return self.piv


def verdict(piv: torch.Tensor) -> Optional[bool]:
    """The proof's rule on the pivots, read back in one sync (least pivot,
    largest |pivot|, negatives, zeros): True when every pivot is above
    tiny = 1e-12 max(max|d|, 1), False when one is below -tiny, None
    otherwise and at a zero, NaN or infinite pivot (fails closed)."""
    mn, mx, _, zeros = torch.stack([
        piv.min(), piv.abs().max(), (piv < 0).sum().to(piv.dtype),
        (piv == 0).sum().to(piv.dtype)]).tolist()
    if zeros or not (math.isfinite(mn) and math.isfinite(mx)):
        return None
    tiny = 1e-12 * max(mx, 1.0)
    if mn > tiny:
        return True
    if mn < -tiny:
        return False
    return None


class ShiftedProof:
    """``prove(t)``: the verdict of csrc/ldlt.cu's LDL^T on S + tI for
    shifts t of one S (scipy sparse, RA ordering of `dims`) on a CUDA
    device; S's duplicate entries are summed first.  The analysis runs at
    the first call (a span "certify/ldlt_analyse" into `times`); S's values
    go to the card once; each proof is one run of the kernel (counter
    "ldlt.device")."""

    def __init__(self, S, dims: ProblemDims, device, times=None):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"ShiftedProof factors on a CUDA device, not "
                             f"{self.device}")
        self.S, self.dims, self.times = S.tocsr(), dims, times
        self.S.sum_duplicates()
        self.plan = None
        self.values = None

    def pivots(self, t: float) -> torch.Tensor:
        """Pivots of S + tI, in the analysis' permuted order."""
        if self.plan is None:
            with span("certify/ldlt_analyse", into=self.times):
                an = analyse(self.S, self.dims)
            self.plan = DeviceFactor(an, self.device)
            self.values = torch.as_tensor(self.S.data, dtype=torch.float64,
                                          device=self.device)
        count("ldlt.device")
        return self.plan.factor(self.values, t)

    def __call__(self, t: float) -> Optional[bool]:
        return verdict(self.pivots(t))
