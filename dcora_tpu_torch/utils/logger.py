"""Trajectory and measurement logging.

reference: Logger.cpp:21-145 -- CSV measurement dumps with quaternions and
GNC weights, and TUM-style trajectories
(`# pose_index x y z qx qy qz qw`).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from dcora_tpu_torch.measurements import (
    RangeMeasurement,
    RelativePoseLandmarkMeasurement,
    RelativePosePoseMeasurement,
)
from dcora_tpu_torch.utils.rotations import rotation_to_quat


class Logger:
    def __init__(self, log_directory: str):
        self.log_directory = log_directory
        if log_directory:
            os.makedirs(log_directory, exist_ok=True)

    def _path(self, filename: str) -> str:
        return os.path.join(self.log_directory, filename)

    def log_trajectory(self, d: int, n: int, T: np.ndarray, filename: str):
        """TUM-style: pose_index x y z qx qy qz qw (z=0 for 2D).

        T: [n, d, d+1].
        """
        with open(self._path(filename), "w") as f:
            f.write("# pose_index x y z qx qy qz qw\n")
            for i in range(n):
                t = T[i, :, d]
                if d == 2:
                    x, y, z = t[0], t[1], 0.0
                    theta = np.arctan2(T[i, 1, 0], T[i, 0, 0])
                    q = np.array(
                        [0.0, 0.0, np.sin(theta / 2), np.cos(theta / 2)]
                    )
                else:
                    x, y, z = t
                    q = rotation_to_quat(T[i, :, :3])
                f.write(
                    f"{i} {x} {y} {z} {q[0]} {q[1]} {q[2]} {q[3]}\n"
                )

    def log_measurements(self, measurements: List[object], filename: str):
        with open(self._path(filename), "w") as f:
            f.write(
                "# type robot_src pose_src robot_dst pose_dst "
                "qx qy qz qw tx ty tz kappa tau weight fixed_weight\n"
            )
            for m in measurements:
                if isinstance(m, RelativePosePoseMeasurement):
                    d = m.t.shape[0]
                    if d == 2:
                        theta = np.arctan2(m.R[1, 0], m.R[0, 0])
                        q = np.array(
                            [0, 0, np.sin(theta / 2), np.cos(theta / 2)]
                        )
                        t = np.array([m.t[0], m.t[1], 0.0])
                    else:
                        q = rotation_to_quat(m.R)
                        t = m.t
                    f.write(
                        f"PosePose {m.r1} {m.p1} {m.r2} {m.p2} "
                        f"{q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} "
                        f"{m.kappa} {m.tau} {m.weight} "
                        f"{int(m.fixedWeight)}\n"
                    )
                elif isinstance(m, RelativePoseLandmarkMeasurement):
                    t = m.t if m.t.shape[0] == 3 else np.array(
                        [m.t[0], m.t[1], 0.0]
                    )
                    f.write(
                        f"PoseLandmark {m.r1} {m.p1} {m.r2} {m.p2} "
                        f"0 0 0 1 {t[0]} {t[1]} {t[2]} 0 {m.tau} "
                        f"{m.weight} {int(m.fixedWeight)}\n"
                    )
                elif isinstance(m, RangeMeasurement):
                    f.write(
                        f"Range {m.r1} {m.p1} {m.r2} {m.p2} 0 0 0 1 "
                        f"{m.range} 0 0 0 {m.precision} {m.weight} "
                        f"{int(m.fixedWeight)}\n"
                    )


def write_matrix_to_file(M: np.ndarray, filename: str) -> None:
    """Dense matrix as full-precision CSV rows
    (reference: writeMatrixToFile, DCORA_utils.cpp:147-159)."""
    M = np.asarray(M)
    with open(filename, "w") as f:
        for row in np.atleast_2d(M):
            f.write(", ".join(repr(float(x)) for x in row) + "\n")


def write_sparse_matrix_to_file(M, filename: str) -> None:
    """Sparse matrix as "row,col,value" COO lines
    (reference: writeSparseMatrixToFile, DCORA_utils.cpp:161-177)."""
    coo = M.tocoo()
    with open(filename, "w") as f:
        for i, j, v in zip(coo.row, coo.col, coo.data):
            f.write(f"{int(i)},{int(j)},{float(v)!r}\n")


def read_matrix_from_file(filename: str) -> np.ndarray:
    """Round-trip reader for write_matrix_to_file output."""
    rows = []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(x) for x in line.split(",")])
    return np.array(rows)


def read_sparse_matrix_from_file(filename: str):
    """Round-trip reader for write_sparse_matrix_to_file output."""
    import scipy.sparse as sp

    rows, cols, vals = [], [], []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if line:
                i, j, v = line.split(",")
                rows.append(int(i))
                cols.append(int(j))
                vals.append(float(v))
    return sp.coo_matrix((vals, (rows, cols)))
