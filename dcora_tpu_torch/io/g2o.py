"""g2o file parser.

Behavioral parity with the reference parser (DCORA_utils.cpp:179-375):
  * VERTEX_SE2 / VERTEX_SE3:QUAT populate ground-truth poses
  * EDGE_SE2: tau = 2/trace(inv(I_t)),  kappa = I33
  * EDGE_SE3:QUAT: tau = 3/trace(inv(I_t)), kappa = 3/(2*trace(inv(I_R)))
    where I_t, I_R are the translation/rotation blocks of the g2o
    *information* matrix (the information-divergence-minimizing isotropic
    approximations)
  * consecutive pose ids (i+1 == j) are odometry -> fixedWeight=True

Implemented with bulk numpy parsing: lines are grouped per record type and
all floats of a group are converted in one ``np.loadtxt`` pass, which is
10-50x faster than per-line float() on the 100k-edge benchmark files.

As in dcora_tpu.io.g2o, the native C++ parser (dcora_tpu_torch.native) is
preferred when its library is built; the dataset's ``reader`` says which of
the two read the file.
"""

from __future__ import annotations

import io

import numpy as np

from dcora_tpu_torch.measurements import G2ODataset, RelativePosePoseMeasurement
from dcora_tpu_torch.types import PoseID

from dcora_tpu_torch.utils.rotations import quat_to_rotation, theta_to_rotation


def _bulk_floats(lines, expected_cols: int) -> np.ndarray:
    """Parse homogeneous whitespace-separated float lines in one pass."""
    if not lines:
        return np.zeros((0, expected_cols))
    arr = np.loadtxt(io.StringIO("\n".join(lines)), dtype=np.float64, ndmin=2)
    assert arr.shape[1] == expected_cols, (
        f"expected {expected_cols} columns, got {arr.shape[1]}"
    )
    return arr


def _dataset_from_arrays(dim, v_ids, v_R, v_t, e_i, e_j, e_R, e_t,
                         e_kappa, e_tau) -> G2ODataset:
    """Assemble a G2ODataset from the native parser's flat arrays."""
    ds = G2ODataset(dim=dim)
    ds.reader = "native"
    d = dim
    for k in range(len(v_ids)):
        T = np.zeros((d, d + 1))
        T[:, :d] = v_R[k]
        T[:, d] = v_t[k]
        ds.ground_truth_poses[PoseID(0, int(v_ids[k]))] = T
    max_idx = -1
    for k in range(len(e_i)):
        i, j = int(e_i[k]), int(e_j[k])
        ds.pose_pose_measurements.append(
            RelativePosePoseMeasurement(
                r1=0, p1=i, r2=0, p2=j, R=e_R[k], t=e_t[k],
                kappa=float(e_kappa[k]), tau=float(e_tau[k]),
                fixedWeight=(i + 1 == j),
            )
        )
        max_idx = max(max_idx, i, j)
    ds.num_poses = max_idx + 1
    return ds


def read_g2o_file(filename: str) -> G2ODataset:
    from dcora_tpu_torch import native

    a = native.parse_g2o(filename)
    if a is not None:
        return _dataset_from_arrays(
            a.dim, a.v_ids, a.v_R, a.v_t, a.e_i, a.e_j, a.e_R, a.e_t,
            a.e_kappa, a.e_tau)

    ds = G2ODataset()

    v2, v3, e2, e3 = [], [], [], []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token, _, rest = line.partition(" ")
            if token == "EDGE_SE3:QUAT":
                e3.append(rest)
            elif token == "EDGE_SE2":
                e2.append(rest)
            elif token == "VERTEX_SE3:QUAT":
                v3.append(rest)
            elif token == "VERTEX_SE2":
                v2.append(rest)
            elif token == "FIX":
                # anchor declaration (g2o convention; e.g. ais2klinik.g2o)
                # -- the first pose is gauge-fixed downstream, skip
                continue
            else:
                raise ValueError(f"unrecognized g2o record type: {token!r}")

    if e3 or v3:
        assert not (e2 or v2), "mixed 2D/3D g2o file"
        ds.dim = 3
    elif e2 or v2:
        ds.dim = 2
    else:
        raise ValueError(f"empty g2o file: {filename}")

    # --- ground truth vertices ---------------------------------------------
    if ds.dim == 2:
        arr = _bulk_floats(v2, 4)  # i x y theta
        for row in arr:
            i = int(row[0])
            T = np.zeros((2, 3))
            T[:, :2] = theta_to_rotation(row[3])
            T[:, 2] = row[1:3]
            pid = PoseID(0, i)
            if pid in ds.ground_truth_poses:
                raise ValueError(f"duplicate pose ID {pid}")
            ds.ground_truth_poses[pid] = T
    else:
        arr = _bulk_floats(v3, 8)  # i x y z qx qy qz qw
        for row in arr:
            i = int(row[0])
            T = np.zeros((3, 4))
            T[:, :3] = quat_to_rotation(row[4:8])
            T[:, 3] = row[1:4]
            pid = PoseID(0, i)
            if pid in ds.ground_truth_poses:
                raise ValueError(f"duplicate pose ID {pid}")
            ds.ground_truth_poses[pid] = T

    # --- edges --------------------------------------------------------------
    max_idx = -1
    if ds.dim == 2:
        # i j dx dy dtheta I11 I12 I13 I22 I23 I33
        arr = _bulk_floats(e2, 11)
        ii = arr[:, 0].astype(np.int64)
        jj = arr[:, 1].astype(np.int64)
        ts = arr[:, 2:4]
        Rs = theta_to_rotation(arr[:, 4])
        # analytic 2x2 inverse-trace (matches Eigen's cofactor inverse,
        # important for near-singular information matrices)
        I11, I12, I22 = arr[:, 5], arr[:, 6], arr[:, 8]
        taus = 2.0 * (I11 * I22 - I12 * I12) / (I11 + I22)
        kappas = arr[:, 10]
    else:
        # i j dx dy dz qx qy qz qw I11..I16 I22..I26 I33..I36 I44..I46 I55 I56 I66
        arr = _bulk_floats(e3, 30)
        ii = arr[:, 0].astype(np.int64)
        jj = arr[:, 1].astype(np.int64)
        ts = arr[:, 2:5]
        Rs = quat_to_rotation(arr[:, 5:9])
        # analytic 3x3 inverse-trace: trace(inv(M)) = trace(adj(M))/det(M)
        # (matches Eigen's cofactor inverse for near-singular inputs)
        def trace_inv_sym3(a, b, c, e, f, i):
            det = a * (e * i - f * f) - b * (b * i - f * c) \
                + c * (b * f - e * c)
            adj = (e * i - f * f) + (a * i - c * c) + (a * e - b * b)
            return adj / det

        taus = 3.0 / trace_inv_sym3(
            arr[:, 9], arr[:, 10], arr[:, 11],
            arr[:, 15], arr[:, 16], arr[:, 20],
        )
        kappas = 3.0 / (2.0 * trace_inv_sym3(
            arr[:, 24], arr[:, 25], arr[:, 26],
            arr[:, 27], arr[:, 28], arr[:, 29],
        ))

    for k in range(len(ii)):
        i, j = int(ii[k]), int(jj[k])
        ds.pose_pose_measurements.append(
            RelativePosePoseMeasurement(
                r1=0,
                p1=i,
                r2=0,
                p2=j,
                R=Rs[k],
                t=ts[k],
                kappa=float(kappas[k]),
                tau=float(taus[k]),
                fixedWeight=(i + 1 == j),
            )
        )
        max_idx = max(max_idx, i, j)

    ds.num_poses = max_idx + 1
    return ds
