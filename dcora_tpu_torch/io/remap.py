"""Local<->global state remapping for PyFG datasets.

reference: getLocalToGlobalStateMapping / getGlobalMeasurements /
getRobotMeasurements (DCORA_utils.cpp:1169-1512): the global (centralized)
problem reindexes every robot's states consecutively from zero under a single
CENTRALIZED_AGENT_ID; per-robot problems reindex each robot's own states from
zero and keep cross-robot edges as shared measurements.

Counterpart of ``dcora_tpu.io.remap``; the ground-truth states it attaches
are the port's host-side (CPU, float64) RAStates.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict

import numpy as np

from dcora_tpu_torch.core import lifted
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.measurements import (
    Measurements,
    PyFGDataset,
    RangeMeasurement,
)
from dcora_tpu_torch.types import (
    CENTRALIZED_AGENT_ID,
    LandmarkID,
    PoseID,
    StateID,
    StateType,
    UnitSphereID,
)


@dataclasses.dataclass
class LocalToGlobalStateDicts:
    poses: Dict[StateID, StateID] = dataclasses.field(default_factory=dict)
    landmarks: Dict[StateID, StateID] = dataclasses.field(default_factory=dict)
    unit_spheres: Dict[StateID, StateID] = dataclasses.field(
        default_factory=dict
    )


def get_local_to_global_state_mapping(
    ds: PyFGDataset, reindex_local_states: bool = True
) -> LocalToGlobalStateDicts:
    out = LocalToGlobalStateDicts()
    gid = CENTRALIZED_AGENT_ID
    for gp_idx, local_id in enumerate(sorted(ds.ground_truth.poses)):
        lid = local_id
        if reindex_local_states:
            lid = PoseID(
                local_id.robot_id,
                local_id.frame_id
                - ds.robot_id_to_first_pose_idx[local_id.robot_id],
            )
        out.poses[lid] = PoseID(gid, gp_idx)
    for gl_idx, local_id in enumerate(sorted(ds.ground_truth.landmarks)):
        lid = local_id
        if reindex_local_states:
            lid = LandmarkID(
                local_id.robot_id,
                local_id.frame_id
                - ds.robot_id_to_first_landmark_idx[local_id.robot_id],
            )
        out.landmarks[lid] = LandmarkID(gid, gl_idx)
    for gu_idx, local_id in enumerate(sorted(ds.ground_truth.unit_spheres)):
        out.unit_spheres[local_id] = UnitSphereID(gid, gu_idx)
    return out


def get_global_measurements(ds: PyFGDataset) -> Measurements:
    """Reindex all measurements into one centralized agent, with a
    ground-truth RAState initialization attached."""
    mapping = get_local_to_global_state_mapping(ds, reindex_local_states=False)
    out = Measurements()

    for m in ds.measurements.relative_measurements:
        m = copy.copy(m)
        if isinstance(m, RangeMeasurement):
            src = (mapping.poses if m.stateType1 == StateType.Pose
                   else mapping.landmarks)[m.src_id()]
            dst = (mapping.poses if m.stateType2 == StateType.Pose
                   else mapping.landmarks)[m.dst_id()]
            m.l = mapping.unit_spheres[m.unit_sphere_id()].frame_id
        else:
            src = (mapping.poses if m.stateType1 == StateType.Pose
                   else mapping.landmarks)[m.src_id()]
            dst = (mapping.poses if m.stateType2 == StateType.Pose
                   else mapping.landmarks)[m.dst_id()]
        m.r1, m.p1 = src.robot_id, src.frame_id
        m.r2, m.p2 = dst.robot_id, dst.frame_id
        out.relative_measurements.append(m)

    # ground truth init as rank-d RAState (global index order)
    d = ds.dim
    n = sum(ds.robot_id_to_num_poses.values())
    l = sum(ds.robot_id_to_num_unit_spheres.values())  # noqa: E741
    b = sum(ds.robot_id_to_num_landmarks.values())
    T = np.zeros((n, d, d + 1))
    lmks = np.zeros((b, d))
    sphs = np.zeros((l, d))
    for local_id, pose in ds.ground_truth.poses.items():
        T[mapping.poses[local_id].frame_id] = pose
    for local_id, lm in ds.ground_truth.landmarks.items():
        lmks[mapping.landmarks[local_id].frame_id] = lm
    for local_id, u in ds.ground_truth.unit_spheres.items():
        sphs[mapping.unit_spheres[local_id].frame_id] = u
    out.ground_truth_init = lifted.from_pose_array(
        T, l=l, b=b, landmarks=lmks, spheres=sphs
    )
    return out


def robot_global_indices(ds: PyFGDataset) -> Dict[int, Dict[str, np.ndarray]]:
    """Per-robot arrays of global indices, ordered by (reindexed) local idx.

    out[robot] = {"poses": [n_r], "spheres": [l_r], "landmarks": [b_r]}
    mapping local index -> global index, for slicing global RAStates into
    agent blocks and back (used by the multi-robot RA-SLAM driver).
    """
    mapping = get_local_to_global_state_mapping(ds, reindex_local_states=True)
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for robot in ds.robot_IDs:
        n = ds.robot_id_to_num_poses.get(robot, 0)
        l = ds.robot_id_to_num_unit_spheres.get(robot, 0)  # noqa: E741
        b = ds.robot_id_to_num_landmarks.get(robot, 0)
        poses = np.zeros(n, dtype=np.int64)
        sphs = np.zeros(l, dtype=np.int64)
        lmks = np.zeros(b, dtype=np.int64)
        for lid, gid in mapping.poses.items():
            if lid.robot_id == robot:
                poses[lid.frame_id] = gid.frame_id
        for lid, gid in mapping.unit_spheres.items():
            if lid.robot_id == robot:
                sphs[lid.frame_id] = gid.frame_id
        for lid, gid in mapping.landmarks.items():
            if lid.robot_id == robot:
                lmks[lid.frame_id] = gid.frame_id
        out[robot] = {"poses": poses, "spheres": sphs, "landmarks": lmks}
    return out


def get_robot_measurements(ds: PyFGDataset) -> Dict[int, Measurements]:
    """Per-robot measurement partitions, reindexed from zero.

    reference: getRobotMeasurements (DCORA_utils.cpp:1371-1512). Cross-robot
    measurements appear in both robots' partitions.
    """
    out: Dict[int, Measurements] = {}
    first_pose: Dict[int, int] = {}
    first_landmark: Dict[int, int] = {}

    for robot in ds.robot_IDs:
        meas = Measurements()
        pose_ids, lmk_ids = set(), set()
        for p in ds.measurements.pose_priors:
            if p.r == robot:
                meas.pose_priors.append(copy.copy(p))
                pose_ids.add(p.p)
        for p in ds.measurements.landmark_priors:
            if p.r == robot:
                meas.landmark_priors.append(copy.copy(p))
                lmk_ids.add(p.p)
        for m in ds.measurements.relative_measurements:
            if robot not in (m.r1, m.r2):
                continue
            meas.relative_measurements.append(copy.copy(m))
            for (r, p, st) in ((m.r1, m.p1, m.stateType1),
                               (m.r2, m.p2, m.stateType2)):
                if r == robot:
                    (pose_ids if st == StateType.Pose else lmk_ids).add(p)

        def consecutive(ids):
            s = sorted(ids)
            return all(b - a == 1 for a, b in zip(s, s[1:]))

        assert consecutive(pose_ids), f"non-consecutive pose ids robot {robot}"
        assert consecutive(lmk_ids), (
            f"non-consecutive landmark ids robot {robot}"
        )
        first_pose[robot] = min(pose_ids) if pose_ids else 0
        first_landmark[robot] = min(lmk_ids) if lmk_ids else 0
        out[robot] = meas

    # reindex from zero
    for robot, meas in out.items():
        for p in meas.pose_priors:
            p.p -= first_pose[robot]
        for p in meas.landmark_priors:
            p.p -= first_landmark[robot]
        for m in meas.relative_measurements:
            for attr_r, attr_p, st in (("r1", "p1", m.stateType1),
                                       ("r2", "p2", m.stateType2)):
                r = getattr(m, attr_r)
                offs = (first_pose if st == StateType.Pose
                        else first_landmark).get(r, 0)
                setattr(m, attr_p, getattr(m, attr_p) - offs)

    # ground-truth inits per robot
    for robot in ds.robot_IDs:
        d = ds.dim
        n = ds.robot_id_to_num_poses.get(robot, 0)
        l = ds.robot_id_to_num_unit_spheres.get(robot, 0)  # noqa: E741
        b = ds.robot_id_to_num_landmarks.get(robot, 0)
        T = np.zeros((n, d, d + 1))
        lmks = np.zeros((b, d))
        sphs = np.zeros((l, d))
        for local_id, pose in ds.ground_truth.poses.items():
            if local_id.robot_id == robot:
                T[local_id.frame_id - first_pose[robot]] = pose
        for local_id, lm in ds.ground_truth.landmarks.items():
            if local_id.robot_id == robot:
                lmks[local_id.frame_id - first_landmark[robot]] = lm
        for local_id, u in ds.ground_truth.unit_spheres.items():
            if local_id.robot_id == robot:
                sphs[local_id.frame_id] = u
        out[robot].ground_truth_init = lifted.from_pose_array(
            T, l=l, b=b, landmarks=lmks, spheres=sphs
        )
    return out
