"""Lifted state container and layout helpers.

Counterpart of ``dcora_tpu.core.lifted``.  The canonical internal layout is
the RA ordering (reference: Elements.h:178-183, Graph.cpp:824-1188):

    X = [ Y_1 .. Y_n | s_1 .. s_l | p_1 .. p_n | L_1 .. L_b ]  in R^{r x k},
    k = d*n + l + n + b

stored as three structured tensors:

    rot: [n, r, d]    lifted rotation (Stiefel) blocks
    sph: [l, r]       unit-sphere columns
    trn: [n+b, r]     pose translations followed by landmark translations

PGO/SE problems are RA problems with l = b = 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dcora_tpu_torch.types import ProblemDims


class RAState(NamedTuple):
    """Lifted RA-SLAM state: a tuple of three tensors on one device."""

    rot: torch.Tensor  # [n, r, d]
    sph: torch.Tensor  # [l, r]
    trn: torch.Tensor  # [n+b, r]

    @property
    def r(self) -> int:
        return self.rot.shape[1]

    @property
    def d(self) -> int:
        return self.rot.shape[2]

    @property
    def n(self) -> int:
        return self.rot.shape[0]

    @property
    def l(self) -> int:  # noqa: E743
        return self.sph.shape[0]

    @property
    def b(self) -> int:
        return self.trn.shape[0] - self.rot.shape[0]

    @property
    def dims(self) -> ProblemDims:
        return ProblemDims(self.d, self.n, self.l, self.b)

    @property
    def device(self) -> torch.device:
        return self.rot.device

    @property
    def dtype(self) -> torch.dtype:
        return self.rot.dtype

    def pose(self, i) -> torch.Tensor:
        """Lifted pose i as [r, d+1] = [Y_i | p_i]."""
        return torch.cat([self.rot[i], self.trn[i][:, None]], dim=1)

    # -- algebra -------------------------------------------------------------
    def __add__(self, other: "RAState") -> "RAState":
        return RAState(*(x + y for x, y in zip(self, other)))

    def __sub__(self, other: "RAState") -> "RAState":
        return RAState(*(x - y for x, y in zip(self, other)))

    def scale(self, a) -> "RAState":
        return RAState(*(a * x for x in self))

    def vdot(self, other: "RAState") -> torch.Tensor:
        return sum((x * y).sum() for x, y in zip(self, other))

    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.vdot(self))

    def to(self, *args, **kwargs) -> "RAState":
        return RAState(*(x.to(*args, **kwargs) for x in self))


def zeros(dims: ProblemDims, r: int, dtype=torch.float64,
          device="cpu") -> RAState:
    return RAState(
        rot=torch.zeros((dims.n, r, dims.d), dtype=dtype, device=device),
        sph=torch.zeros((dims.l, r), dtype=dtype, device=device),
        trn=torch.zeros((dims.num_trans, r), dtype=dtype, device=device),
    )


def to_flat(X: RAState) -> torch.Tensor:
    """RAState -> dense [r, k] in RA column ordering."""
    r = X.r
    rot_flat = X.rot.permute(1, 0, 2).reshape(r, -1)  # [r, d*n]
    return torch.cat([rot_flat, X.sph.T, X.trn.T], dim=1)


def from_flat(M: torch.Tensor, dims: ProblemDims) -> RAState:
    """Dense [r, k] in RA ordering -> RAState."""
    r = M.shape[0]
    if M.shape[1] != dims.k:
        raise ValueError(f"flat width {M.shape[1]} != k = {dims.k}")
    d, n, l = dims.d, dims.n, dims.l  # noqa: E741
    rot = M[:, :d * n].reshape(r, n, d).permute(1, 0, 2)
    sph = M[:, d * n:d * n + l].T
    trn = M[:, d * n + l:].T
    return RAState(rot=rot.contiguous(), sph=sph.contiguous(),
                   trn=trn.contiguous())


def to_se_matrix(X: RAState) -> torch.Tensor:
    """RAState -> reference SE interleaved layout [r, (d+1)n], poses only."""
    # [n, r, d+1] -> [r, n*(d+1)]
    blocks = torch.cat([X.rot, X.trn[:X.n, :, None]], dim=2)
    return blocks.permute(1, 0, 2).reshape(X.r, -1)


def from_se_matrix(M, d: int) -> RAState:
    """Reference SE interleaved layout [r, (d+1)n] -> RAState (l=b=0)."""
    M = torch.as_tensor(M)
    r = M.shape[0]
    n = M.shape[1] // (d + 1)
    blocks = M.reshape(r, n, d + 1).permute(1, 0, 2)  # [n, r, d+1]
    return RAState(rot=blocks[:, :, :d].contiguous(),
                   sph=torch.zeros((0, r), dtype=M.dtype, device=M.device),
                   trn=blocks[:, :, d].contiguous())


def from_pose_array(T: np.ndarray, l: int = 0, b: int = 0,  # noqa: E741
                    landmarks: Optional[np.ndarray] = None,
                    spheres: Optional[np.ndarray] = None,
                    device="cpu", dtype=torch.float64) -> RAState:
    """Rank-d state from host pose array T: [n, d, d+1] (+optional extras).

    landmarks: [b, d]; spheres: [l, d]. Missing extras are zero.
    """
    T = np.asarray(T)
    n, d = T.shape[0], T.shape[1]
    trn = np.zeros((n + b, d))
    trn[:n] = T[:, :, d]
    if landmarks is not None and b:
        trn[n:] = landmarks
    sph = np.zeros((l, d))
    if spheres is not None and l:
        sph[:] = spheres

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return RAState(rot=t(T[:, :, :d]), sph=t(sph), trn=t(trn))


def lift(X: RAState, Y_lift: torch.Tensor) -> RAState:
    """Lift a rank-d state to rank r via X_lifted = Y_lift @ X.

    Y_lift: [r, d] fixed Stiefel lifting matrix (reference: Agent.cpp:49-50,
    512-517). In the block layout each column block is left-multiplied.
    """
    return RAState(
        rot=torch.einsum("rd,nde->nre", Y_lift, X.rot),
        sph=torch.einsum("rd,ld->lr", Y_lift, X.sph),
        trn=torch.einsum("rd,td->tr", Y_lift, X.trn),
    )


def pad_rank(X: RAState, r_new: int) -> RAState:
    """Zero-pad the rank (row) dimension to r_new."""
    pad = r_new - X.r
    if pad < 0:
        raise ValueError(f"pad_rank: rank {X.r} > {r_new}")
    pd = torch.nn.functional.pad
    return RAState(
        rot=pd(X.rot, (0, 0, 0, pad)),
        sph=pd(X.sph, (0, pad)),
        trn=pd(X.trn, (0, pad)),
    )


def truncate_rank(X: RAState, r_new: int) -> RAState:
    return RAState(rot=X.rot[:, :r_new, :], sph=X.sph[:, :r_new],
                   trn=X.trn[:, :r_new])


def to_numpy(X: RAState) -> tuple:
    """(rot, sph, trn) as host float64 arrays."""
    return tuple(x.detach().cpu().numpy() for x in X)


# --- host-side SE(d) helpers (numpy) -----------------------------------------


def pose_identity(d: int) -> np.ndarray:
    T = np.zeros((d, d + 1))
    T[:, :d] = np.eye(d)
    return T


def pose_inverse(T: np.ndarray) -> np.ndarray:
    d = T.shape[0]
    out = np.zeros_like(T)
    out[:, :d] = T[:, :d].T
    out[:, d] = -T[:, :d].T @ T[:, d]
    return out


def pose_multiply(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    d = A.shape[0]
    out = np.zeros_like(A)
    out[:, :d] = A[:, :d] @ B[:, :d]
    out[:, d] = A[:, :d] @ B[:, d] + A[:, d]
    return out
