"""Carry the JAX package's objects across into the port's.

Turns ``dcora_tpu`` objects -- given as numpy arrays or as objects whose
attributes are arrays (jax arrays convert through ``np.asarray``) -- into
the port's ``RAState``, ``ProblemData``, ``Preconditioner`` and
``TiledProblem``, so both engines can be fed bit-identical state.  This
module imports no JAX itself.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dcora_tpu_torch.core import problem as prob
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.spmm import build_output_csr, to_device
from dcora_tpu_torch.core.spmm_pack import compact_buckets
from dcora_tpu_torch.core.tiled import TiledMeta, TiledProblem, TiledQ


def _a(x) -> np.ndarray:
    return np.array(x)  # a writable host copy


def ra_state(X, device="cpu", dtype=torch.float64) -> RAState:
    """Object with rot/sph/trn arrays -> RAState."""
    return RAState(*(torch.as_tensor(_a(x), dtype=dtype, device=device)
                     for x in (X.rot, X.sph, X.trn)))


def problem_data(P, device="cpu") -> prob.ProblemData:
    """JAX ProblemData (its ELL form, if any, is ignored) -> ProblemData."""
    arrays = {}
    for name in prob.ProblemData._fields:
        v = getattr(P, name, None)
        if v is None:
            continue
        arrays[name] = ((_a(v.rot), _a(v.sph), _a(v.trn))
                        if name == "prior_G" else _a(v))
    return prob.problem_data_from_arrays(arrays, device=device)


def preconditioner(M, device="cpu") -> prob.Preconditioner:
    return prob.Preconditioner(*(torch.as_tensor(_a(x), dtype=torch.float64,
                                                 device=device)
                                 for x in (M.pose_inv, M.sph_diag,
                                           M.lmk_diag)))


def _tiles_from_buckets(buckets, T: int) -> Dict[Tuple[int, int], np.ndarray]:
    """Unpack row-grouped wide buffers (single-row [ng, T, G*T] or two-row
    [ng, 2T, G*T]) back into {(row, col): tile}; pad slots add zero."""
    out: Dict[Tuple[int, int], np.ndarray] = {}

    def add(r, c, t):
        key = (int(r), int(c))
        out[key] = out[key] + t if key in out else t.astype(np.float64)

    for grows, gcols, wide in buckets:
        grows, gcols, wide = _a(grows), _a(gcols), _a(wide)
        G = gcols.shape[1]
        for g in range(wide.shape[0]):
            rows = np.atleast_1d(grows[g])
            for h, r in enumerate(rows):
                for j in range(G):
                    add(r, gcols[g, j],
                        wide[g, h * T:(h + 1) * T, j * T:(j + 1) * T])
    return out


def tiled_problem(TPj, device="cpu", dtype=None) -> TiledProblem:
    """JAX TiledProblem -> TiledProblem.

    The upper-triangular tile list comes from the bucketed groups
    (``Q.grp_buckets``) when the JAX build made them, and otherwise from the
    full tile list filtered to row <= col.  All-zero tiles (chunk padding,
    pad slots) are dropped.  The strip CSR of the port's kernel is built
    from that list.  When the JAX build was paired
    (``DCORA_SPMM_PACK=paired``: some bucket has two rows per group), its
    buckets are also carried across, compacted to their non-empty
    sub-blocks, as ``Q.pairs``, so both packages apply the same packs.
    ``dtype`` defaults to the JAX tiles' dtype."""
    m = TPj.meta
    meta = TiledMeta(d=m.d, n=m.n, l=m.l, b=m.b, T=m.T, nt=m.nt)
    T = meta.T
    tiles_j = _a(TPj.Q.tiles)
    dtype = dtype or (torch.float32 if tiles_j.dtype == np.float32
                      else torch.float64)
    buckets = getattr(TPj.Q, "grp_buckets", None)
    paired = None
    if buckets is not None:
        by_key = _tiles_from_buckets(buckets, T)
        if any(_a(gr).ndim == 2 for gr, _, _ in buckets):
            paired = to_device(compact_buckets(
                [tuple(_a(x) for x in b) for b in buckets]), dtype, device)
    else:
        rows, cols = _a(TPj.Q.tile_rows), _a(TPj.Q.tile_cols)
        by_key = {}
        for i in np.nonzero(rows <= cols)[0]:
            key = (int(rows[i]), int(cols[i]))
            by_key[key] = by_key.get(key, 0.0) + tiles_j[i].astype(np.float64)
    keys = sorted((k for k, t in by_key.items() if np.any(t)),
                  key=lambda k: (k[1], k[0]))
    rows = np.array([k[0] for k in keys], np.int64)
    cols = np.array([k[1] for k in keys], np.int64)
    tiles = np.stack([by_key[k] for k in keys]) if keys else \
        np.zeros((1, T, T))
    if not keys:
        rows = cols = np.zeros(1, np.int64)

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    def opt(a):
        return None if a is None else dev(_a(a), dtype)

    Q = TiledQ(
        tiles=dev(tiles, dtype), tile_rows=dev(rows, torch.int64),
        tile_cols=dev(cols, torch.int64),
        strips=to_device(build_output_csr(rows, cols, tiles, meta.nt), dtype,
                         device),
        ra_of_fl=dev(_a(TPj.Q.ra_of_fl), torch.int64),
        fl_of_ra=dev(_a(TPj.Q.fl_of_ra), torch.int64),
        pairs=paired,
    )
    # the JAX package stores the pose inverses planar, [dh, dh, n]
    return TiledProblem(
        Q=Q, meta=meta,
        pose_inv=dev(_a(TPj.pose_inv).transpose(2, 0, 1), dtype),
        sph_inv=dev(_a(TPj.sph_inv), dtype),
        lmk_inv=dev(_a(TPj.lmk_inv), dtype),
        diag_inv=opt(TPj.diag_inv), btd_ltil=opt(TPj.btd_ltil),
        btd_sinv=opt(TPj.btd_sinv),
    )


_PARALLEL_MAPS = ("fix_pose_src", "fix_trans_src", "fix_sph_src",
                  "pub_pose_idx", "pub_lmk_idx", "pub_sph_idx")


def parallel_arrays(pp) -> Dict[str, np.ndarray]:
    """The batched arrays of a parallel RBCD problem, of either engine
    (the JAX package's ParallelRBCDProblem keeps them in ``.batched``), as
    numpy: every ProblemData edge field of P and P_loc, the preconditioner
    M, the gather maps, the public-buffer indices and regs."""
    B = getattr(pp, "batched", pp)
    out = {}
    for part in ("P", "P_loc"):
        Pb = getattr(B, part)
        for name in prob.ProblemData._fields[:24]:
            out[f"{part}.{name}"] = _a(getattr(Pb, name))
    for name in ("pose_inv", "sph_diag", "lmk_diag"):
        out[f"M.{name}"] = _a(getattr(B.M, name))
    for name in _PARALLEL_MAPS:
        out[name] = _a(getattr(B, name))
    out["regs"] = _a(pp.regs)
    return out



def parallel_problem(pp, graphs, device="cpu"):
    """JAX ParallelRBCDProblem -> the port's ParallelRBCDProblem, over the
    port's LocalGraphs of the same agents (`graphs`, for their sizes)."""
    from dcora_tpu_torch.parallel.rbcd import ParallelRBCDProblem

    B = pp.batched

    def ints(x):
        return torch.as_tensor(_a(x).astype(np.int64), device=device)

    return ParallelRBCDProblem(
        P=problem_data(B.P, device), P_loc=problem_data(B.P_loc, device),
        M=preconditioner(B.M, device),
        **{name: ints(getattr(B, name)) for name in _PARALLEL_MAPS},
        **{name: int(getattr(pp, name)) for name in (
            "n_max", "l_max", "b_max", "t_max", "fp_max", "ft_max", "fs_max",
            "pp_max", "plm_max", "ps_max", "d", "num_agents")},
        graphs=list(graphs), regs=_a(pp.regs).astype(np.float64))
