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
LDL^T check.  Only the matvec, and issuing its Lanczos eagerly (no CUDA
graph: it all-reduces), are this module's; the rest is core.certify's.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from dcora_tpu_torch.core import lifted, problem as prob
from dcora_tpu_torch.core.certify import (
    Certificate,
    _eager_sweeps,
    _host_verdict,
    _min_eig_pair,
    _rayleigh_proof,
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


def minimum_eigen_pair_sharded(
        P: ProblemData, C: Certificate, dims: ProblemDims,
        num_shards: int, num_lanczos: int = 64,
        P_sh: Optional[ProblemData] = None, group=None,
        generator: Optional[torch.Generator] = None
) -> Tuple[float, torch.Tensor, float]:
    """(lambda_min, eigvec [k], residual) of S with the matvec sharded over
    `num_shards` edge shards (pass a prebuilt shard_problem_edges P_sh to
    amortize the split), as core.certify.minimum_eigen_pair with the
    shifted start perturbed by the rng that drew v0."""
    if P_sh is None:
        P_sh = shard_problem_edges(P, num_shards)
    mv = make_sharded_matvec(P_sh, C, dims, group)
    rng = np.random.default_rng(0)
    v0 = torch.as_tensor(rng.standard_normal(dims.k), dtype=torch.float64,
                         device=C.rot_blocks.device)
    return _min_eig_pair(lambda shift: partial(mv, shift=shift), v0,
                         num_lanczos, generator, rng, _eager_sweeps)


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
    proof = lam_min + eta < 0 and _rayleigh_proof(
        partial(make_sharded_matvec(P_sh, C, dims, group), shift=0.0),
        v / torch.linalg.vector_norm(v), eta)
    return proof or _host_verdict(P, C, dims, eta, v)
