"""The plain reference's reading of a generated file.

Parses a g2o pose graph (``VERTEX_SE3:QUAT`` / ``EDGE_SE3:QUAT``) or a
PyFG range-aided set (the records ``reference/generators.py`` writes) into
numpy arrays over the global state ordering the solvers use:

    poses in (robot, index) order, unit spheres in (robot of the range's
    first symbol, order of appearance) order, landmarks in (robot, index)
    order; translations are the n poses' followed by the b landmarks'.

Weights follow SE-Sync / CORA: an isotropic pose-pose edge has
kappa = 3 / (2 tr(I_R^-1)) and tau = 3 / tr(I_t^-1) (g2o information) or
kappa = 3 / (2 tr(C_R)), tau = 3 / tr(C_t) (PyFG covariance); a range has
precision 1 / variance.  Imports numpy only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    d: int
    n: int  # poses
    l: int  # unit spheres (one per range)  # noqa: E741
    b: int  # landmarks
    # pose-pose edges
    pp_i: np.ndarray
    pp_j: np.ndarray
    pp_R: np.ndarray  # [m, d, d]
    pp_t: np.ndarray  # [m, d]
    pp_kappa: np.ndarray
    pp_tau: np.ndarray
    # pose-landmark edges (landmark index in [0, b))
    pl_i: np.ndarray
    pl_k: np.ndarray
    pl_t: np.ndarray
    pl_tau: np.ndarray
    # ranges: translation indices in [0, n + b), sphere index, range, 1/var
    rg_a: np.ndarray
    rg_b: np.ndarray
    rg_q: np.ndarray
    rg_rho: np.ndarray
    rg_prec: np.ndarray
    # ground truth from the vertices (PyFG: for the start)
    gt_T: np.ndarray  # [n, d, d+1]
    gt_lmk: np.ndarray  # [b, d]
    # first global pose index and pose count of each robot, in order
    robots: List[Tuple[int, int]] = dataclasses.field(default_factory=list)

    @property
    def k(self) -> int:
        """Columns of the lifted state: d n rotations, l spheres, n + b
        translations."""
        return self.d * self.n + self.l + self.n + self.b

    @property
    def is_pgo(self) -> bool:
        return self.l == 0 and self.b == 0


def quat_to_rotation(q) -> np.ndarray:
    """Rotations [m, 3, 3] from quaternions [m, 4] (qx, qy, qz, qw),
    normalized first."""
    q = np.asarray(q, dtype=np.float64)
    x, y, z, w = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def _sym(vals: np.ndarray, k: int) -> np.ndarray:
    """Symmetric [m, k, k] from row-major upper triangles [m, k(k+1)/2]."""
    C = np.zeros((len(vals), k, k))
    iu = np.triu_indices(k)
    C[:, iu[0], iu[1]] = vals
    C[:, iu[1], iu[0]] = vals
    return C


def _records(path: str) -> Dict[str, List[List[str]]]:
    out: Dict[str, List[List[str]]] = {}
    with open(path) as f:
        for line in f:
            p = line.split()
            if p:
                out.setdefault(p[0], []).append(p[1:])
    return out


def _floats(rows, lo: int, hi: int) -> np.ndarray:
    return np.array([r[lo:hi] for r in rows], dtype=np.float64).reshape(
        len(rows), hi - lo)


def read(path: str) -> Graph:
    if path.endswith(".g2o"):
        return read_g2o(path)
    if path.endswith(".pyfg"):
        return read_pyfg(path)
    raise ValueError(f"reference: unknown file type {path!r}")


E = np.zeros(0, dtype=np.int64)


def read_g2o(path: str) -> Graph:
    rec = _records(path)
    unknown = set(rec) - {"VERTEX_SE3:QUAT", "EDGE_SE3:QUAT"}
    if unknown:
        raise ValueError(f"reference: unknown g2o records {unknown}")
    ed = rec["EDGE_SE3:QUAT"]
    ij = np.array([r[:2] for r in ed], dtype=np.int64)
    v = _floats(ed, 2, 30)
    info = _sym(v[:, 7:28], 6)
    n = int(ij.max()) + 1
    gt = np.zeros((n, 3, 4))
    vt = rec.get("VERTEX_SE3:QUAT", [])
    if vt:
        ids = np.array([r[0] for r in vt], dtype=np.int64)
        vv = _floats(vt, 1, 8)
        gt[ids, :, :3] = quat_to_rotation(vv[:, 3:7])
        gt[ids, :, 3] = vv[:, :3]
    return Graph(
        d=3, n=n, l=0, b=0, pp_i=ij[:, 0], pp_j=ij[:, 1],
        pp_R=quat_to_rotation(v[:, 3:7]), pp_t=v[:, :3],
        pp_kappa=3.0 / (2.0 * np.trace(np.linalg.inv(info[:, 3:, 3:]),
                                       axis1=1, axis2=2)),
        pp_tau=3.0 / np.trace(np.linalg.inv(info[:, :3, :3]), axis1=1,
                              axis2=2),
        pl_i=E, pl_k=E, pl_t=np.zeros((0, 3)), pl_tau=np.zeros(0),
        rg_a=E, rg_b=E, rg_q=E, rg_rho=np.zeros(0), rg_prec=np.zeros(0),
        gt_T=gt, gt_lmk=np.zeros((0, 3)), robots=[(0, n)])


def _symbol(sym: str) -> Tuple[str, int, int]:
    """('pose' | 'lmk', robot, index) of a PyFG symbol: 'A12' is robot A's
    pose 12, 'L3' the map's landmark 3, 'LB3' robot B's landmark 3."""
    if sym[0] == "L":
        if sym[1].isupper():
            return "lmk", ord(sym[1]) - ord("A"), int(sym[2:])
        return "lmk", ord("M") - ord("A"), int(sym[1:])
    return "pose", ord(sym[0]) - ord("A"), int(sym[1:])


def read_pyfg(path: str) -> Graph:
    rec = _records(path)
    unknown = set(rec) - {"VERTEX_SE3:QUAT", "VERTEX_XYZ", "EDGE_SE3:QUAT",
                          "EDGE_SE3_XYZ", "EDGE_RANGE"}
    if unknown:
        raise ValueError(f"reference: unknown PyFG records {unknown}")
    vp = rec.get("VERTEX_SE3:QUAT", [])
    pose_keys = [_symbol(r[1])[1:] for r in vp]
    vv = _floats(vp, 2, 9)
    T = np.zeros((len(vp), 3, 4))
    T[:, :, :3] = quat_to_rotation(vv[:, 3:7])
    T[:, :, 3] = vv[:, :3]
    poses = dict(zip(pose_keys, T))
    vl = rec.get("VERTEX_XYZ", [])
    lmks = dict(zip([_symbol(r[0])[1:] for r in vl], _floats(vl, 1, 4)))
    pose_ids = sorted(poses)
    lmk_ids = sorted(lmks)
    pidx = {k: i for i, k in enumerate(pose_ids)}
    lidx = {k: i for i, k in enumerate(lmk_ids)}
    n, b = len(pose_ids), len(lmk_ids)

    def trn(s):
        kind, r, i = s
        return pidx[(r, i)] if kind == "pose" else n + lidx[(r, i)]

    pp = rec.get("EDGE_SE3:QUAT", [])
    v = _floats(pp, 3, 31)
    C = _sym(v[:, 7:28], 6)
    pl = rec.get("EDGE_SE3_XYZ", [])
    w = _floats(pl, 3, 12)
    # ranges: duplicates (either direction) are skipped; each range owns
    # a sphere, numbered per robot of its first symbol
    rg, seen, count = [], set(), {}
    for r in rec.get("EDGE_RANGE", []):
        s1, s2 = _symbol(r[1]), _symbol(r[2])
        if (s1, s2) in seen or (s2, s1) in seen:
            continue
        seen.add((s1, s2))
        q = count.get(s1[1], 0)
        count[s1[1]] = q + 1
        rg.append((trn(s1), trn(s2), (s1[1], q), float(r[3]), float(r[4])))
    sidx = {k: i for i, k in enumerate(sorted(e[2] for e in rg))}
    robots = []
    for r in sorted({r for r, _ in pose_ids}):
        mine = [pidx[k] for k in pose_ids if k[0] == r]
        robots.append((min(mine), len(mine)))
    return Graph(
        d=3, n=n, l=len(rg), b=b,
        pp_i=np.array([pidx[_symbol(r[1])[1:]] for r in pp], dtype=np.int64),
        pp_j=np.array([pidx[_symbol(r[2])[1:]] for r in pp], dtype=np.int64),
        pp_R=quat_to_rotation(v[:, 3:7]), pp_t=v[:, :3],
        pp_kappa=3.0 / (2.0 * np.trace(C[:, 3:, 3:], axis1=1, axis2=2)),
        pp_tau=3.0 / np.trace(C[:, :3, :3], axis1=1, axis2=2),
        pl_i=np.array([pidx[_symbol(r[1])[1:]] for r in pl], dtype=np.int64),
        pl_k=np.array([lidx[_symbol(r[2])[1:]] for r in pl], dtype=np.int64),
        pl_t=w[:, :3], pl_tau=3.0 / np.trace(_sym(w[:, 3:9], 3), axis1=1,
                                             axis2=2),
        rg_a=np.array([e[0] for e in rg], dtype=np.int64),
        rg_b=np.array([e[1] for e in rg], dtype=np.int64),
        rg_q=np.array([sidx[e[2]] for e in rg], dtype=np.int64),
        rg_rho=np.array([e[3] for e in rg]),
        rg_prec=1.0 / np.array([e[4] for e in rg]),
        gt_T=np.stack([poses[k] for k in pose_ids]),
        gt_lmk=(np.stack([lmks[k] for k in lmk_ids]) if lmk_ids
                else np.zeros((0, 3))),
        robots=robots)
