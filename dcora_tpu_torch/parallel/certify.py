"""Sharded certification: the Lanczos S matvec split over edge shards.

Counterpart of ``dcora_tpu.parallel.certify``.  The reference certifies
centrally (Spectra Lanczos over one sparse S, DCORA_utils.cpp:1807-1896).
Here the dominant cost, the S matvec, becomes

    S v  =  sum_a ( v Q_a )  -  v Lambda(X),

where Q_a holds one shard of the measurement SoA.  A rank runs one
segment-sum pass of ``problem.apply_Q`` over its shards together, and an
``all_reduce`` over the torch.distributed group adds the ranks' partial
products (the JAX package's ``psum`` over the mesh axis).  The Lambda(X)
term is block-diagonal and applied on every rank.  Shards are padded with
zero-weight edges, so any shard count divides any problem; the Lanczos
iteration itself (core.certify's, with full reorthogonalization) runs
replicated.

A deliberate difference: the fresh Lanczos vectors after a breakdown come
from a ``torch.Generator`` where the JAX package draws from ``jax.random``;
the start vector and the restart's perturbation keep numpy's
``default_rng(0)``, as in JAX.  The PSD verdict is confirmed by the host
LDL^T check (``core.certify._min_eig_host``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dcora_tpu_torch.core import lifted, problem as prob
from dcora_tpu_torch.core.certify import (
    Certificate,
    _lanczos,
    _min_eig_host,
    _ritz_extreme,
    dual_certificate_blocks,
)
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.problem import ProblemData, with_segments
from dcora_tpu_torch.parallel.rbcd import group_shape
from dcora_tpu_torch.types import ProblemDims

_EDGE_FIELDS = ProblemData._fields[:24]


def shard_problem_edges(P: ProblemData, num_shards: int) -> ProblemData:
    """ProblemData with every edge field reshaped to [A, chunk, ...], padded
    with zero-weight edges (their index-0 gathers contribute nothing), and
    the prior diagonals as A copies scaled by 1/A (additive, so the sum
    over shards rebuilds them).  The prior linear term takes no part in the
    S matvec and is dropped."""
    A = num_shards
    fields = {}
    for group in (_EDGE_FIELDS[:10], _EDGE_FIELDS[10:17], _EDGE_FIELDS[17:]):
        m = getattr(P, group[0]).shape[0]
        chunk = max(1, -(-m // A))
        for name in group:
            x = getattr(P, name)
            pad = x.new_zeros((A * chunk - m,) + x.shape[1:])
            fields[name] = torch.cat([x, pad]).reshape(
                (A, chunk) + x.shape[1:])
    kd, td = P.prior_kdiag, P.prior_tdiag
    return P._replace(
        **fields, prior_G=None, seg=None,
        prior_kdiag=None if kd is None else (kd / A).expand(A, *kd.shape),
        prior_tdiag=None if td is None else (td / A).expand(A, *td.shape))


def _shards_of(P_sh: ProblemData, lo: int, hi: int) -> ProblemData:
    """Shards lo..hi-1 as one ProblemData: their edges in one list, their
    prior parts summed."""
    out = {name: getattr(P_sh, name)[lo:hi].flatten(0, 1)
           for name in _EDGE_FIELDS}
    for name in ("prior_kdiag", "prior_tdiag"):
        x = getattr(P_sh, name)
        out[name] = None if x is None else x[lo:hi].sum(0)
    return with_segments(ProblemData(**out))


def make_sharded_matvec(P_sh: ProblemData, C: Certificate, dims: ProblemDims,
                        group=None):
    """v -> v S + shift v over the flat [k] RA ordering: this rank's shards
    (A/W contiguous ones, W the group's world size) in one apply_Q pass,
    then an all_reduce of the partial products when W > 1."""
    W, rank = group_shape(group)
    A = P_sh.pp_ri.shape[0]
    if A % W:
        raise ValueError(f"{A} shards do not split over {W} ranks")
    Pr = _shards_of(P_sh, rank * (A // W), (rank + 1) * (A // W))

    def mv(v, shift):
        V = lifted.from_flat(v[None, :], dims)
        w = lifted.to_flat(prob.apply_Q(Pr, V))[0]
        if W > 1:
            import torch.distributed as dist

            dist.all_reduce(w, group=group)
        lam = RAState(rot=torch.einsum("nrd,nde->nre", V.rot, C.rot_blocks),
                      sph=V.sph * C.sph_diag[:, None],
                      trn=torch.zeros_like(V.trn))
        return w - lifted.to_flat(lam)[0] + shift * v

    return mv


def _sweep(mv, shift, v0, m: int, generator):
    """Largest-magnitude Ritz pair of S + shift I after m Lanczos steps
    (dcora_tpu/parallel/certify.py:127-162)."""
    return _ritz_extreme(*_lanczos(lambda v: mv(v, shift), v0, m, 1e-12,
                                   generator))


def minimum_eigen_pair_sharded(
        P: ProblemData, C: Certificate, dims: ProblemDims,
        num_shards: int, num_lanczos: int = 64,
        P_sh: Optional[ProblemData] = None, group=None,
        generator: Optional[torch.Generator] = None
) -> Tuple[float, torch.Tensor, float]:
    """(lambda_min, eigvec [k], residual) of S with the matvec sharded over
    `num_shards` edge shards (pass a prebuilt shard_problem_edges P_sh to
    amortize the split), spectrum-shifted and restarted as the JAX
    package's."""
    if P_sh is None:
        P_sh = shard_problem_edges(P, num_shards)
    mv = make_sharded_matvec(P_sh, C, dims, group)
    m = min(num_lanczos, dims.k)
    dev = C.rot_blocks.device
    f64 = dict(dtype=torch.float64, device=dev)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    zero = torch.zeros((), **f64)

    rng = np.random.default_rng(0)
    v0 = torch.as_tensor(rng.standard_normal(dims.k), **f64)
    lam_lm, y_lm, res_lm = _sweep(mv, zero, v0, m, gen)
    lam_lm_f = float(lam_lm)
    if lam_lm_f < 0:
        return lam_lm_f, y_lm, float(res_lm)

    e0 = torch.zeros(dims.k, **f64)
    e0[0] = 1.0
    row0 = mv(e0, zero)
    pert = rng.standard_normal(dims.k)
    pert /= np.linalg.norm(pert)
    v0s = row0 + 0.03 * torch.linalg.vector_norm(row0) * \
        torch.as_tensor(pert, **f64)
    if float(torch.linalg.vector_norm(v0s)) < 1e-12:
        v0s = torch.as_tensor(rng.standard_normal(dims.k), **f64)
    # restarted sweeps (see core.certify.minimum_eigen_pair: a single sweep
    # can miss a clustered bottom eigenvalue and falsely certify)
    lam_best, y_best, res_best = None, None, 0.0
    stagnant = 0
    for _ in range(40):
        lam_s, y_s, res_s = _sweep(mv, -2.0 * lam_lm, v0s, m, gen)
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


def fast_verification_sharded(P: ProblemData, X: RAState, eta: float,
                              num_shards: int, num_lanczos: int = 64,
                              group=None,
                              generator: Optional[torch.Generator] = None):
    """Sharded core.certify.fast_verification: (is_psd, theta,
    min_eigenvector).  "Not PSD" is proven by an exact Rayleigh quotient;
    "PSD" is confirmed by the host LDL^T check."""
    C = dual_certificate_blocks(P, X)
    dims = X.dims
    P_sh = shard_problem_edges(P, num_shards)
    lam_min, v, _ = minimum_eigen_pair_sharded(
        P, C, dims, num_shards, num_lanczos, P_sh=P_sh, group=group,
        generator=generator)
    if lam_min + eta < 0:
        mv = make_sharded_matvec(P_sh, C, dims, group)
        vj = v / torch.linalg.vector_norm(v)
        theta = float(torch.dot(vj, mv(vj, torch.zeros_like(vj[0]))))
        if theta + eta < 0:
            return False, theta, vj
    certified, lam_host, v_host = _min_eig_host(P, C, dims, eta)
    if certified:
        return True, 0.0, None
    if v_host is not None:
        v = torch.as_tensor(v_host, dtype=torch.float64, device=X.device)
    return False, lam_host, v
