"""Measurement data model.

Python-level measurement records mirroring include/DCORA/Measurements.h
(reference: Measurements.h:34-882). These are host-side bookkeeping objects;
the compute path consumes the SoA arrays produced by
:mod:`dcora_tpu_torch.core.problem`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from dcora_tpu_torch.types import (
    EdgeID,
    LandmarkID,
    MeasurementType,
    PoseID,
    StateID,
    StateType,
    UnitSphereID,
)


@dataclasses.dataclass
class PosePrior:
    """Pose prior (reference: Measurements.h:34-116)."""

    r: int
    p: int
    R: np.ndarray  # (d, d)
    t: np.ndarray  # (d,)
    kappa: float
    tau: float
    weight: float = 1.0
    fixedWeight: bool = True


@dataclasses.dataclass
class LandmarkPrior:
    """Landmark prior (reference: Measurements.h:120-180)."""

    r: int
    p: int
    t: np.ndarray
    tau: float
    weight: float = 1.0
    fixedWeight: bool = True


@dataclasses.dataclass
class RelativePosePoseMeasurement:
    """Relative SE(d) measurement (reference: Measurements.h:246-327)."""

    r1: int
    p1: int
    r2: int
    p2: int
    R: np.ndarray  # (d, d)
    t: np.ndarray  # (d,)
    kappa: float
    tau: float
    weight: float = 1.0
    fixedWeight: bool = False

    stateType1 = StateType.Pose
    stateType2 = StateType.Pose
    measurementType = MeasurementType.PosePose

    def src_id(self) -> StateID:
        return PoseID(self.r1, self.p1)

    def dst_id(self) -> StateID:
        return PoseID(self.r2, self.p2)

    def edge_id(self) -> EdgeID:
        return EdgeID(self.src_id(), self.dst_id(), self.measurementType)


@dataclasses.dataclass
class RelativePoseLandmarkMeasurement:
    """Pose->landmark translation measurement (reference: Measurements.h:331-410)."""

    r1: int
    p1: int
    r2: int
    p2: int
    t: np.ndarray  # (d,)
    tau: float
    weight: float = 1.0
    fixedWeight: bool = False

    stateType1 = StateType.Pose
    stateType2 = StateType.Landmark
    measurementType = MeasurementType.PoseLandmark

    def src_id(self) -> StateID:
        return PoseID(self.r1, self.p1)

    def dst_id(self) -> StateID:
        return LandmarkID(self.r2, self.p2)

    def edge_id(self) -> EdgeID:
        return EdgeID(self.src_id(), self.dst_id(), self.measurementType)


@dataclasses.dataclass
class RangeMeasurement:
    """Range measurement with its unit-sphere variable
    (reference: Measurements.h:414-495). ``l`` is the unit-sphere index owned
    by the *source* robot r1 (reference: DCORA_utils.cpp:1095-1100)."""

    r1: int
    p1: int
    r2: int
    p2: int
    stateType1: StateType
    stateType2: StateType
    l: int  # noqa: E741 - unit sphere index (owned by r1)
    range: float
    precision: float
    weight: float = 1.0
    fixedWeight: bool = False

    measurementType = MeasurementType.Range

    def src_id(self) -> StateID:
        return StateID(self.r1, self.p1, self.stateType1)

    def dst_id(self) -> StateID:
        return StateID(self.r2, self.p2, self.stateType2)

    def unit_sphere_id(self) -> StateID:
        return UnitSphereID(self.r1, self.l)

    def edge_id(self) -> EdgeID:
        return EdgeID(self.src_id(), self.dst_id(), self.measurementType)


RelativeMeasurement = (
    RelativePosePoseMeasurement,
    RelativePoseLandmarkMeasurement,
    RangeMeasurement,
)


@dataclasses.dataclass
class Measurements:
    """All measurements of one (sub)problem (reference: Measurements.h:650-676)."""

    pose_priors: List[PosePrior] = dataclasses.field(default_factory=list)
    landmark_priors: List[LandmarkPrior] = dataclasses.field(default_factory=list)
    relative_measurements: List[object] = dataclasses.field(default_factory=list)
    ground_truth_init: Optional[object] = None  # RAState, set by parsers

    def pose_pose(self) -> List[RelativePosePoseMeasurement]:
        return [
            m
            for m in self.relative_measurements
            if isinstance(m, RelativePosePoseMeasurement)
        ]

    def pose_landmark(self) -> List[RelativePoseLandmarkMeasurement]:
        return [
            m
            for m in self.relative_measurements
            if isinstance(m, RelativePoseLandmarkMeasurement)
        ]

    def ranges(self) -> List[RangeMeasurement]:
        return [m for m in self.relative_measurements if isinstance(m, RangeMeasurement)]


@dataclasses.dataclass
class GroundTruth:
    """Ground-truth dictionaries (reference: Measurements.h:702-722)."""

    poses: Dict[StateID, np.ndarray] = dataclasses.field(default_factory=dict)
    landmarks: Dict[StateID, np.ndarray] = dataclasses.field(default_factory=dict)
    unit_spheres: Dict[StateID, np.ndarray] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class G2ODataset:
    """Parsed g2o file (reference: Measurements.h:765-813)."""

    dim: int = 0
    num_poses: int = 0
    pose_pose_measurements: List[RelativePosePoseMeasurement] = dataclasses.field(
        default_factory=list
    )
    ground_truth_poses: Dict[StateID, np.ndarray] = dataclasses.field(
        default_factory=dict
    )
    # which parser read the file: "native" (dcora_tpu_torch.native) or
    # "numpy"; a class attribute, not a field, so the dataset's fields stay
    # those of the JAX package's
    reader = "numpy"


@dataclasses.dataclass
class PyFGDataset:
    """Parsed PyFG file (reference: Measurements.h:818-882)."""

    dim: int = 0
    robot_IDs: set = dataclasses.field(default_factory=set)
    robot_id_to_num_poses: Dict[int, int] = dataclasses.field(default_factory=dict)
    robot_id_to_num_landmarks: Dict[int, int] = dataclasses.field(default_factory=dict)
    robot_id_to_num_unit_spheres: Dict[int, int] = dataclasses.field(
        default_factory=dict
    )
    robot_id_to_first_pose_idx: Dict[int, int] = dataclasses.field(default_factory=dict)
    robot_id_to_first_landmark_idx: Dict[int, int] = dataclasses.field(
        default_factory=dict
    )
    measurements: Measurements = dataclasses.field(default_factory=Measurements)
    ground_truth: GroundTruth = dataclasses.field(default_factory=GroundTruth)
    # which parser read the file: "native" (dcora_tpu_torch.native) or
    # "numpy"; a class attribute, not a field, so the dataset's fields stay
    # those of the JAX package's
    reader = "numpy"
