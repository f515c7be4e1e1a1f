"""Manifold operations on the product St(d,r)^n x OB(r)^l x R^{r x (n+b)}.

Counterpart of ``dcora_tpu.core.manifold``: batched functions replacing the
reference's ROPTLIB containers (LiftedManifold.cpp:18-89) and matrix-form
helpers (DCORA_utils.cpp:1661-1711, 2033-2051).

  * project:          metric projection onto the manifold
  * tangent_project:  V - Y sym(Y^T V) per Stiefel block; oblique column
                      de-projection; identity on Euclidean blocks
  * retract:          polar retraction per Stiefel block, column
                      renormalization on the oblique factor

Rows of X above the active rank that are zero stay zero under all of these
maps, which lets the staircase run at a padded rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.types import ProblemDims


def _sym(P: torch.Tensor) -> torch.Tensor:
    return 0.5 * (P + P.transpose(-1, -2))


# cuSOLVER's batched eigh (syevBatched) refuses batches of 97,336 and of
# 32,768 3x3 float32 matrices (CUSOLVER_STATUS_INVALID_VALUE from its
# bufferSize query, CUDA 12.8 on one H100) and takes 10,648; larger
# batches go in pieces of this many
EIGH_BATCH = 8192


def _eigh(G: torch.Tensor):
    if not G.is_cuda or G.dim() < 3 or G.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(G)
    parts = [torch.linalg.eigh(g) for g in torch.split(G, EIGH_BATCH)]
    return (torch.cat([w for w, _ in parts]),
            torch.cat([U for _, U in parts]))


def inv_sqrt_psd(G: torch.Tensor) -> torch.Tensor:
    """Batched inverse matrix square root of small SPD matrices via eigh.
    A zero block (a padded pose of a stack of agents) maps to a finite
    matrix, so its zero state stays zero under the polar retraction."""
    w, U = _eigh(G)
    floor = 1e-300 if w.dtype == torch.float64 else torch.finfo(w.dtype).tiny
    inv_sqrt_w = 1.0 / torch.sqrt(torch.clamp(w, min=floor))
    # U diag(w^-1/2) U^T as one batched matmul (a three-operand einsum pays
    # a contraction-path search on every call)
    return (U * inv_sqrt_w[..., None, :]) @ U.transpose(-1, -2)


def stiefel_project(A: torch.Tensor) -> torch.Tensor:
    """Polar factor of A ([..., r, d]): A (A^T A)^{-1/2}
    (reference: projectToStiefelManifold, DCORA_utils.cpp:1677-1683)."""
    G = torch.einsum("...ri,...rj->...ij", A, A)
    return torch.einsum("...rd,...de->...re", A, inv_sqrt_psd(G))


def rotation_project(M: torch.Tensor) -> torch.Tensor:
    """Nearest SO(d) matrix: SVD with determinant fix
    (reference: projectToRotationGroup, DCORA_utils.cpp:1661-1675)."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    flip = torch.where(det < 0, -1.0, 1.0).to(M.dtype)
    U = U.clone()
    U[..., :, -1] = U[..., :, -1] * flip[..., None]
    return U @ Vt


def oblique_project(S: torch.Tensor) -> torch.Tensor:
    """Row-normalize ([l, r] rows are the sphere vectors)
    (reference: projectToObliqueManifold, DCORA_utils.cpp:1685-1693)."""
    nrm = torch.linalg.vector_norm(S, dim=-1, keepdim=True)
    return S / torch.where(nrm == 0, torch.ones_like(nrm), nrm)


def project(X: RAState) -> RAState:
    """Metric projection of an arbitrary ambient point onto the manifold."""
    return RAState(rot=stiefel_project(X.rot), sph=oblique_project(X.sph),
                   trn=X.trn)


def tangent_project(X: RAState, V: RAState) -> RAState:
    """Project ambient V onto the tangent space at X
    (reference: DCORA_utils.cpp:2033-2051)."""
    P = torch.einsum("nri,nrj->nij", X.rot, V.rot)
    rot = V.rot - torch.einsum("nrd,nde->nre", X.rot, _sym(P))
    inner = (X.sph * V.sph).sum(dim=-1, keepdim=True)
    return RAState(rot=rot, sph=V.sph - X.sph * inner, trn=V.trn)


def retract(X: RAState, V: RAState) -> RAState:
    """Retraction: polar on Stiefel blocks, normalize on oblique, add on R."""
    return RAState(rot=stiefel_project(X.rot + V.rot),
                   sph=oblique_project(X.sph + V.sph), trn=X.trn + V.trn)


# --- random generators --------------------------------------------------------
# The JAX package draws from jax.random, whose stream torch cannot
# reproduce; here every draw takes an explicit torch.Generator, and tests
# that compare the two packages inject the same numpy-made arrays instead.


def random_stiefel(n: int, r: int, d: int, generator: torch.Generator,
                   dtype=torch.float64, device="cpu") -> torch.Tensor:
    """n random Stiefel blocks [n, r, d] (polar factor of a Gaussian)."""
    A = torch.randn((n, r, d), generator=generator, dtype=dtype,
                    device=device)
    return stiefel_project(A)


def random_oblique(l: int, r: int, generator: torch.Generator,  # noqa: E741
                   dtype=torch.float64, device="cpu") -> torch.Tensor:
    """l random unit vectors [l, r] (normalized Gaussian rows)."""
    return oblique_project(torch.randn((l, r), generator=generator,
                                       dtype=dtype, device=device))


def random_state(dims: ProblemDims, r: int, generator: torch.Generator,
                 dtype=torch.float64, device="cpu") -> RAState:
    rot = random_stiefel(dims.n, r, dims.d, generator, dtype, device)
    sph = random_oblique(dims.l, r, generator, dtype, device)
    trn = torch.randn((dims.num_trans, r), generator=generator, dtype=dtype,
                      device=device)
    return RAState(rot=rot, sph=sph, trn=trn)


def fixed_lifting_matrix(r: int, d: int,
                         generator: Optional[torch.Generator] = None,
                         dtype=torch.float64, device="cpu") -> torch.Tensor:
    """Deterministic Stiefel matrix [r, d] (reference: fixedStiefelVariable,
    DCORA_utils.cpp:2053-2057).  Determinism comes from the generator,
    seeded with 1 when none is given."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(1)
    return random_stiefel(1, r, d, generator, dtype, device)[0]


# --- feasibility checks -------------------------------------------------------


def stiefel_error(Y: torch.Tensor) -> torch.Tensor:
    d = Y.shape[-1]
    G = torch.einsum("...ri,...rj->...ij", Y, Y)
    return (G - torch.eye(d, dtype=Y.dtype, device=Y.device)).abs().max()


def oblique_error(S: torch.Tensor) -> torch.Tensor:
    if S.shape[0] == 0:
        return torch.zeros((), dtype=S.dtype, device=S.device)
    return (torch.linalg.vector_norm(S, dim=-1) - 1.0).abs().max()


def manifold_error(X: RAState) -> torch.Tensor:
    return torch.maximum(stiefel_error(X.rot), oblique_error(X.sph))
