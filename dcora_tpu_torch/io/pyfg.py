"""PyFG file parser.

Counterpart of ``dcora_tpu.io.pyfg``: as there, the native C++ parser
(dcora_tpu_torch.native) is preferred when its library is built, and the
numpy parser below runs otherwise; the dataset's ``reader`` says which.

Behavioral parity with the reference parser (DCORA_utils.cpp:437-1167):
  * symbol decoding: 'A'..'Z' poses per robot; 'L'-prefixed landmarks
    ('L12' -> map robot, 'LB3' -> robot B); map robot id = 'M'-'A' = 12
  * covariances are given directly; tau = dim/trace(cov_t);
    kappa = 1/cov (2D) or 3/(2*trace(cov_R)) (3D)
  * range measurements allocate one unit-sphere variable per unique range
    edge, owned by the source robot, and compute its ground truth as
    (t_src - t_dst).normalized(); duplicate range edges are skipped
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dcora_tpu_torch.measurements import (
    LandmarkPrior,
    PosePrior,
    PyFGDataset,
    RangeMeasurement,
    RelativePoseLandmarkMeasurement,
    RelativePosePoseMeasurement,
)
from dcora_tpu_torch.types import (
    FIRST_AGENT_SYMBOL,
    LANDMARK_SYMBOL,
    MAP_SYMBOL,
    LandmarkID,
    PoseID,
    StateType,
)
from dcora_tpu_torch.utils.rotations import quat_to_rotation, theta_to_rotation

_DIM_BY_TOKEN = {
    "VERTEX_SE2": 2,
    "VERTEX_SE3:QUAT": 3,
    "VERTEX_SE2:PRIOR": 2,
    "VERTEX_SE3:QUAT:PRIOR": 3,
    "VERTEX_XY": 2,
    "VERTEX_XYZ": 3,
    "VERTEX_XY:PRIOR": 2,
    "VERTEX_XYZ:PRIOR": 3,
    "EDGE_SE2": 2,
    "EDGE_SE3:QUAT": 3,
    "EDGE_SE2_XY": 2,
    "EDGE_SE3_XYZ": 3,
}


def _symbol_to_ids(sym: str) -> Tuple[int, int, StateType]:
    """Decode a PyFG symbol to (robot_id, state_id, state_type).

    reference: DCORA_utils.cpp:585-625 (getRobotAndStateIDFromSymbol).
    """
    if sym[0] == LANDMARK_SYMBOL:
        if sym[1].isupper():
            robot = ord(sym[1]) - ord(FIRST_AGENT_SYMBOL)
            state = int(sym[2:])
        else:
            robot = ord(MAP_SYMBOL) - ord(FIRST_AGENT_SYMBOL)
            state = int(sym[1:])
        return robot, state, StateType.Landmark
    if sym[0].isupper():
        return ord(sym[0]) - ord(FIRST_AGENT_SYMBOL), int(sym[1:]), StateType.Pose
    raise ValueError(f"cannot decode PyFG symbol: {sym!r}")


def _sym_cov(vals, dim: int) -> np.ndarray:
    """Upper-triangular row-major values -> symmetric matrix."""
    cov = np.zeros((dim, dim))
    idx = 0
    for i in range(dim):
        for j in range(i, dim):
            cov[i, j] = cov[j, i] = vals[idx]
            idx += 1
    assert idx == len(vals), f"covariance length mismatch: {len(vals)} vs {idx}"
    return cov


def _tau(cov_t: np.ndarray) -> float:
    return cov_t.shape[0] / np.trace(cov_t)


def _kappa(cov_R: np.ndarray) -> float:
    if cov_R.shape[0] == 1:
        return 1.0 / cov_R[0, 0]
    return 3.0 / (2.0 * np.trace(cov_R))


def _dataset_from_native(a) -> PyFGDataset:
    """Assemble a PyFGDataset from the native parser's flat arrays."""
    ds = PyFGDataset()
    ds.reader = "native"
    ds.dim = d = a.dim

    for k in range(len(a.gp_robot)):
        robot, state = int(a.gp_robot[k]), int(a.gp_state[k])
        ds.robot_IDs.add(robot)
        T = np.zeros((d, d + 1))
        T[:, :d] = a.gp_R[k]
        T[:, d] = a.gp_t[k]
        ds.ground_truth.poses[PoseID(robot, state)] = T
        ds.robot_id_to_num_poses[robot] = (
            ds.robot_id_to_num_poses.get(robot, 0) + 1
        )
        prev = ds.robot_id_to_first_pose_idx.get(robot, state)
        ds.robot_id_to_first_pose_idx[robot] = min(prev, state)

    for k in range(len(a.gl_robot)):
        robot, state = int(a.gl_robot[k]), int(a.gl_state[k])
        ds.robot_IDs.add(robot)
        ds.ground_truth.landmarks[LandmarkID(robot, state)] = a.gl_t[k]
        ds.robot_id_to_num_landmarks[robot] = (
            ds.robot_id_to_num_landmarks.get(robot, 0) + 1
        )
        prev = ds.robot_id_to_first_landmark_idx.get(robot, state)
        ds.robot_id_to_first_landmark_idx[robot] = min(prev, state)

    for k in range(len(a.prp_robot)):
        ds.measurements.pose_priors.append(
            PosePrior(
                r=int(a.prp_robot[k]), p=int(a.prp_state[k]),
                R=a.prp_R[k], t=a.prp_t[k],
                kappa=float(a.prp_kappa[k]), tau=float(a.prp_tau[k]),
            )
        )
    for k in range(len(a.prl_robot)):
        ds.measurements.landmark_priors.append(
            LandmarkPrior(
                r=int(a.prl_robot[k]), p=int(a.prl_state[k]),
                t=a.prl_t[k], tau=float(a.prl_tau[k]),
            )
        )

    # re-interleave relative measurements in file order via seq
    rel = {}
    for k in range(len(a.pp["seq"])):
        rel[int(a.pp["seq"][k])] = RelativePosePoseMeasurement(
            r1=int(a.pp["r1"][k]), p1=int(a.pp["p1"][k]),
            r2=int(a.pp["r2"][k]), p2=int(a.pp["p2"][k]),
            R=a.pp_R[k], t=a.pp_t[k],
            kappa=float(a.pp_kappa[k]), tau=float(a.pp_tau[k]),
        )
    for k in range(len(a.pl["seq"])):
        rel[int(a.pl["seq"][k])] = RelativePoseLandmarkMeasurement(
            r1=int(a.pl["r1"][k]), p1=int(a.pl["p1"][k]),
            r2=int(a.pl["r2"][k]), p2=int(a.pl["p2"][k]),
            t=a.pl_t[k], tau=float(a.pl_tau[k]),
        )
    for k in range(len(a.rg["seq"])):
        r1 = int(a.rg["r1"][k])
        m = RangeMeasurement(
            r1=r1, p1=int(a.rg["p1"][k]),
            r2=int(a.rg["r2"][k]), p2=int(a.rg["p2"][k]),
            stateType1=(StateType.Pose if int(a.rg["st1"][k]) == 0
                        else StateType.Landmark),
            stateType2=(StateType.Pose if int(a.rg["st2"][k]) == 0
                        else StateType.Landmark),
            l=int(a.rg["l"][k]), range=float(a.rg_range[k]),
            precision=float(a.rg_prec[k]),
        )
        rel[int(a.rg["seq"][k])] = m
        ds.ground_truth.unit_spheres[m.unit_sphere_id()] = a.rg_u[k]
        ds.robot_id_to_num_unit_spheres[r1] = (
            ds.robot_id_to_num_unit_spheres.get(r1, 0) + 1
        )
    ds.measurements.relative_measurements = [
        rel[s] for s in sorted(rel)
    ]

    for robot in ds.robot_IDs:
        for counter in (
            ds.robot_id_to_num_poses,
            ds.robot_id_to_num_landmarks,
            ds.robot_id_to_num_unit_spheres,
        ):
            counter.setdefault(robot, 0)
    return ds


def read_pyfg_file(filename: str) -> PyFGDataset:
    from dcora_tpu_torch import native

    a = native.parse_pyfg(filename)
    if a is not None:
        return _dataset_from_native(a)

    ds = PyFGDataset()
    sphere_idx = {}  # robot id -> next unit sphere index
    seen_range_edges = set()

    def bump(counter, robot):
        counter[robot] = counter.get(robot, 0) + 1

    def update_first(first_idx, robot, idx):
        first_idx[robot] = min(first_idx.get(robot, idx), idx)

    with open(filename) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            token = parts[0]
            if ds.dim == 0 and token in _DIM_BY_TOKEN:
                ds.dim = _DIM_BY_TOKEN[token]
            d = ds.dim

            if token in ("VERTEX_SE2", "VERTEX_SE3:QUAT"):
                # ts sym x y (z) theta | qx qy qz qw
                sym = parts[2]
                vals = np.array([float(v) for v in parts[3:]])
                t = vals[:d]
                R = (
                    theta_to_rotation(vals[2])
                    if d == 2
                    else quat_to_rotation(vals[3:7])
                )
                robot, state, _ = _symbol_to_ids(sym)
                ds.robot_IDs.add(robot)
                pid = PoseID(robot, state)
                if pid in ds.ground_truth.poses:
                    raise ValueError(f"duplicate pose ID {pid}")
                T = np.zeros((d, d + 1))
                T[:, :d] = R
                T[:, d] = t
                ds.ground_truth.poses[pid] = T
                bump(ds.robot_id_to_num_poses, robot)
                update_first(ds.robot_id_to_first_pose_idx, robot, state)

            elif token in ("VERTEX_SE2:PRIOR", "VERTEX_SE3:QUAT:PRIOR"):
                sym = parts[2]
                vals = np.array([float(v) for v in parts[3:]])
                t = vals[:d]
                if d == 2:
                    R = theta_to_rotation(vals[2])
                    cov = _sym_cov(vals[3:9], 3)
                    cov_t, cov_R = cov[:2, :2], cov[2:, 2:]
                else:
                    R = quat_to_rotation(vals[3:7])
                    cov = _sym_cov(vals[7:28], 6)
                    cov_t, cov_R = cov[:3, :3], cov[3:, 3:]
                robot, state, _ = _symbol_to_ids(sym)
                ds.measurements.pose_priors.append(
                    PosePrior(
                        r=robot, p=state, R=R, t=t,
                        kappa=_kappa(cov_R), tau=_tau(cov_t),
                    )
                )

            elif token in ("VERTEX_XY", "VERTEX_XYZ"):
                # sym x y (z) -- note: no timestamp (DCORA_utils.cpp:741)
                sym = parts[1]
                t = np.array([float(v) for v in parts[2 : 2 + d]])
                robot, state, _ = _symbol_to_ids(sym)
                ds.robot_IDs.add(robot)
                lid = LandmarkID(robot, state)
                if lid in ds.ground_truth.landmarks:
                    raise ValueError(f"duplicate landmark ID {lid}")
                ds.ground_truth.landmarks[lid] = t
                bump(ds.robot_id_to_num_landmarks, robot)
                update_first(ds.robot_id_to_first_landmark_idx, robot, state)

            elif token in ("VERTEX_XY:PRIOR", "VERTEX_XYZ:PRIOR"):
                sym = parts[2]
                vals = np.array([float(v) for v in parts[3:]])
                t = vals[:d]
                ncov = d * (d + 1) // 2
                cov = _sym_cov(vals[d : d + ncov], d)
                robot, state, _ = _symbol_to_ids(sym)
                ds.measurements.landmark_priors.append(
                    LandmarkPrior(r=robot, p=state, t=t, tau=_tau(cov))
                )

            elif token in ("EDGE_SE2", "EDGE_SE3:QUAT"):
                sym1, sym2 = parts[2], parts[3]
                vals = np.array([float(v) for v in parts[4:]])
                t = vals[:d]
                if d == 2:
                    R = theta_to_rotation(vals[2])
                    cov = _sym_cov(vals[3:9], 3)
                    cov_t, cov_R = cov[:2, :2], cov[2:, 2:]
                else:
                    R = quat_to_rotation(vals[3:7])
                    cov = _sym_cov(vals[7:28], 6)
                    cov_t, cov_R = cov[:3, :3], cov[3:, 3:]
                r1, p1, _ = _symbol_to_ids(sym1)
                r2, p2, _ = _symbol_to_ids(sym2)
                ds.measurements.relative_measurements.append(
                    RelativePosePoseMeasurement(
                        r1=r1, p1=p1, r2=r2, p2=p2, R=R, t=t,
                        kappa=_kappa(cov_R), tau=_tau(cov_t),
                    )
                )

            elif token in ("EDGE_SE2_XY", "EDGE_SE3_XYZ"):
                sym1, sym2 = parts[2], parts[3]
                vals = np.array([float(v) for v in parts[4:]])
                t = vals[:d]
                ncov = d * (d + 1) // 2
                cov = _sym_cov(vals[d : d + ncov], d)
                r1, p1, _ = _symbol_to_ids(sym1)
                r2, p2, _ = _symbol_to_ids(sym2)
                ds.measurements.relative_measurements.append(
                    RelativePoseLandmarkMeasurement(
                        r1=r1, p1=p1, r2=r2, p2=p2, t=t, tau=_tau(cov)
                    )
                )

            elif token == "EDGE_RANGE":
                # ts sym1 sym2 range cov
                sym1, sym2 = parts[2], parts[3]
                rng = float(parts[4])
                cov = float(parts[5])
                if rng <= 0:
                    raise ValueError(f"range must be positive: {rng}")
                r1, p1, st1 = _symbol_to_ids(sym1)
                r2, p2, st2 = _symbol_to_ids(sym2)
                key = (r1, p1, st1, r2, p2, st2)
                rkey = (r2, p2, st2, r1, p1, st1)
                if key in seen_range_edges or rkey in seen_range_edges:
                    continue  # skip duplicates (DCORA_utils.cpp:1083-1090)
                seen_range_edges.add(key)
                l_idx = sphere_idx.get(r1, 0)
                sphere_idx[r1] = l_idx + 1
                bump(ds.robot_id_to_num_unit_spheres, r1)

                def gt_translation(robot, state, st):
                    if st == StateType.Pose:
                        return ds.ground_truth.poses[PoseID(robot, state)][:, d]
                    return ds.ground_truth.landmarks[LandmarkID(robot, state)]

                u = gt_translation(r1, p1, st1) - gt_translation(r2, p2, st2)
                u = u / np.linalg.norm(u)
                m = RangeMeasurement(
                    r1=r1, p1=p1, r2=r2, p2=p2,
                    stateType1=st1, stateType2=st2,
                    l=l_idx, range=rng, precision=1.0 / cov,
                )
                ds.ground_truth.unit_spheres[m.unit_sphere_id()] = u
                ds.measurements.relative_measurements.append(m)

            else:
                raise ValueError(f"unknown PyFG record type: {token!r}")

    # robots with no states of some type get explicit zero counts
    for robot in ds.robot_IDs:
        for counter in (
            ds.robot_id_to_num_poses,
            ds.robot_id_to_num_landmarks,
            ds.robot_id_to_num_unit_spheres,
        ):
            counter.setdefault(robot, 0)

    return ds
