"""The starting states the benchmark hands to the program and to the
reference alike (numpy and scipy only).

``chordal``: the chordal relaxation of a pose graph, pose 0 anchored at the
identity: rotations from the linear least squares of
kappa ||R_j - R_i R_ij||^2 projected onto SO(3), then translations from the
least squares of tau ||t_j - t_i - R_i t_ij||^2.

``odometry``: each robot's odometry composed from its first pose's
ground-truth vertex, the ground-truth unit direction of every range, and
landmarks drawn uniformly from [-1, 1]^3 by the run's seed.

Both return (rot [n, r, d], sph [l, r], trn [n + b, r]) float64 arrays at
rank r, the rows beyond d zero.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve

from port_bench.reference.graph import Graph


def _project_so3(M: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(M)
    D = np.ones((len(M), 3))
    D[:, 2] = np.sign(np.linalg.det(U @ Vt))
    return (U * D[:, None, :]) @ Vt


def _lift(g: Graph, R, t, sph, lmk, r: int):
    n, d = g.n, g.d
    rot = np.zeros((n, r, d))
    rot[:, :d, :] = R
    trn = np.zeros((n + g.b, r))
    trn[:n, :d] = t
    trn[n:, :d] = lmk
    S = np.zeros((g.l, r))
    S[:, :d] = sph
    return rot, S, trn


def chordal(g: Graph, r: int, seed: int = 0):
    """(The seed is unused: the chordal start is the data's.)"""
    n, d = g.n, g.d
    i, j = g.pp_i, g.pp_j
    m = len(i)
    # rows of each rotation are independent: x_j^T - R_ij^T x_i^T = 0 for
    # each row x of R; unknowns [n * d] per row, with the same matrix
    # row (e, c): +1 at (j, c), -R_ij[a, c] at (i, a) for every a
    e_c = np.arange(m * d)
    rows = np.repeat(e_c, 1 + d)
    e, c = e_c // d, e_c % d
    cols = np.concatenate([(j[e] * d + c)[:, None],
                           i[e][:, None] * d + np.arange(d)[None, :]], 1)
    vals = np.concatenate([np.ones((m * d, 1)),
                           -g.pp_R[e, :, c]], 1)
    w = np.repeat(np.sqrt(g.pp_kappa), d)[:, None]
    B = sp.csr_matrix(((vals * w).ravel(), (rows, cols.ravel())),
                      shape=(m * d, n * d))
    L = (B.T @ B).tocsr()
    # pose 0 is the identity: column a of the right-hand side carries
    # row a of it; one factorisation solves all d rows
    x0 = np.zeros((n * d, d))
    x0[:d] = np.eye(d)
    rhs = -(L @ x0)
    R = np.zeros((n, d, d))
    R[0] = np.eye(d)
    R[1:] = spsolve(L[d:, d:].tocsc(), rhs[d:]).reshape(
        n - 1, d, d).transpose(0, 2, 1)
    R = _project_so3(R)
    # translations: t_j - t_i = R_i t_ij
    rows = np.repeat(np.arange(m), 2)
    cols = np.stack([j, i], 1).ravel()
    vals = np.tile([1.0, -1.0], m)
    sw = np.sqrt(g.pp_tau)
    C = sp.csr_matrix((vals * np.repeat(sw, 2), (rows, cols)), shape=(m, n))
    rhs = sw[:, None] * np.einsum("mab,mb->ma", R[i], g.pp_t)
    t = np.zeros((n, d))
    LC = (C.T @ C).tocsr()
    t[1:] = spsolve(LC[1:, 1:].tocsc(), (C.T @ rhs)[1:]).reshape(n - 1, d)
    return _lift(g, R, t, np.zeros((0, d)), np.zeros((0, d)), r)


def odometry(g: Graph, r: int, seed: int):
    n, d = g.n, g.d
    R = np.zeros((n, d, d))
    t = np.zeros((n, d))
    odo = {}
    for e in range(len(g.pp_i)):
        odo[(int(g.pp_i[e]), int(g.pp_j[e]))] = e
    for first, count in g.robots:
        R[first] = g.gt_T[first][:, :d]
        t[first] = g.gt_T[first][:, d]
        for p in range(first, first + count - 1):
            e = odo.get((p, p + 1))
            if e is None:
                R[p + 1], t[p + 1] = R[p], t[p]
                continue
            R[p + 1] = R[p] @ g.pp_R[e]
            t[p + 1] = t[p] + R[p] @ g.pp_t[e]
    pos = np.concatenate([g.gt_T[:, :, d], g.gt_lmk])
    u = pos[g.rg_a] - pos[g.rg_b]
    sph = np.zeros((g.l, d))
    sph[g.rg_q] = u / np.linalg.norm(u, axis=1, keepdims=True)
    lmk = np.random.default_rng(seed).uniform(-1, 1, size=(g.b, d))
    return _lift(g, R, t, sph, lmk, r)


def ground_truth(g: Graph, r: int, seed: int = 0):
    """The vertices of the file: poses, landmarks, and the unit direction
    of every range between them (the seed is unused)."""
    d = g.d
    pos = np.concatenate([g.gt_T[:, :, d], g.gt_lmk])
    u = pos[g.rg_a] - pos[g.rg_b]
    sph = np.zeros((g.l, d))
    sph[g.rg_q] = u / np.linalg.norm(u, axis=1, keepdims=True)
    return _lift(g, g.gt_T[:, :, :d], g.gt_T[:, :, d], sph, g.gt_lmk, r)


STARTS = {"chordal": chordal, "odometry": odometry,
          "ground_truth": ground_truth}
