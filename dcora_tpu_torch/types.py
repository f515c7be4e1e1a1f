"""Core enums, IDs and parameter structs.

Mirrors the configuration surface of the reference
(include/DCORA/DCORA_types.h:49-233, include/DCORA/Agent.h:40-185,
include/DCORA/DCORA_robust.h:25-84) with identical field names/defaults so
runs are comparable, expressed as Python dataclasses.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import FrozenSet, Optional, Tuple


class InitializationMethod(enum.Enum):
    # reference: DCORA_types.h:49
    Odometry = "Odometry"
    Chordal = "Chordal"
    GNC_TLS = "GNC_TLS"
    Random = "Random"


class BlockSelectionRule(enum.Enum):
    # reference: DCORA_types.h:54
    Uniform = "Uniform"
    Greedy = "Greedy"


class GraphType(enum.Enum):
    # reference: DCORA_types.h:59
    PoseGraph = "PoseGraph"
    RangeAidedSLAMGraph = "RangeAidedSLAMGraph"


class StateType(enum.Enum):
    # reference: DCORA_types.h:64-69
    NONE = "None"
    Pose = "Pose"
    Landmark = "Landmark"
    UnitSphere = "UnitSphere"


class MeasurementType(enum.Enum):
    # reference: DCORA_types.h:70-75
    PosePrior = "PosePrior"
    LandmarkPrior = "LandmarkPrior"
    PosePose = "PosePose"
    PoseLandmark = "PoseLandmark"
    Range = "Range"


class ROptMethod(enum.Enum):
    # reference: DCORA_types.h:156-159
    RTR = "RTR"  # Riemannian trust region with truncated CG
    RGD = "RGD"  # Riemannian gradient descent


class RobustCostType(enum.Enum):
    # reference: DCORA_robust.h:28-35
    L2 = "L2"
    L1 = "L1"
    TLS = "TLS"
    Huber = "Huber"
    GM = "GM"
    GNC_TLS = "GNC_TLS"


# Agent id of the centralized (global) problem (reference: DCORA_types.h:42)
# and the map agent (MAP_SYMBOL 'M' - 'A' = 12).
CENTRALIZED_AGENT_ID = 0
MAP_ID = ord("M") - ord("A")  # 12
FIRST_AGENT_SYMBOL = "A"
LANDMARK_SYMBOL = "L"
MAP_SYMBOL = "M"


@dataclasses.dataclass(frozen=True, order=True)
class StateID:
    """(robot_id, frame_id, state_type) triple.

    reference: DCORA_types.h:236-308 (StateID/PoseID/LandmarkID/UnitSphereID).
    """

    robot_id: int
    frame_id: int
    state_type: StateType = StateType.NONE

    def __repr__(self):
        return f"{self.state_type.value}({self.robot_id},{self.frame_id})"


def PoseID(robot_id: int, frame_id: int) -> StateID:
    return StateID(robot_id, frame_id, StateType.Pose)


def LandmarkID(robot_id: int, frame_id: int) -> StateID:
    return StateID(robot_id, frame_id, StateType.Landmark)


def UnitSphereID(robot_id: int, frame_id: int) -> StateID:
    return StateID(robot_id, frame_id, StateType.UnitSphere)


@dataclasses.dataclass(frozen=True)
class EdgeID:
    """Undirected-unique edge identifier (reference: DCORA_types.h:321-366)."""

    src: StateID
    dst: StateID
    measurement_type: MeasurementType = MeasurementType.PosePose

    def is_odometry(self) -> bool:
        return (
            self.measurement_type == MeasurementType.PosePose
            and self.src.robot_id == self.dst.robot_id
            and self.src.frame_id + 1 == self.dst.frame_id
        )

    def is_shared(self) -> bool:
        return self.src.robot_id != self.dst.robot_id


@dataclasses.dataclass
class ROptParameters:
    """Riemannian optimization parameters (reference: DCORA_types.h:152-200)."""

    method: ROptMethod = ROptMethod.RTR
    verbose: bool = False
    gradnorm_tol: float = 1e-2
    RGD_stepsize: float = 1e-3
    RGD_use_preconditioner: bool = True
    RTR_iterations: int = 3
    RTR_tCG_iterations: int = 50
    RTR_initial_radius: float = 100.0


@dataclasses.dataclass
class RobustCostParameters:
    """Robust cost configuration (reference: DCORA_robust.h:25-84)."""

    costType: RobustCostType = RobustCostType.L2
    GNCMaxNumIters: int = 20
    GNCBarc: float = 5.0
    GNCMuStep: float = 1.4
    GNCInitMu: float = 1e-4
    HuberThreshold: float = 3.0
    TLSThreshold: float = 10.0


@dataclasses.dataclass
class AgentParameters:
    """Per-agent configuration (reference: Agent.h:40-185)."""

    d: int
    r: int
    robotIDs: FrozenSet[int] = frozenset({0})
    graphType: GraphType = GraphType.PoseGraph
    asynchronous: bool = False
    asynchronousOptimizationRate: float = 1.0
    # reference default: Odometry (Agent.h:134)
    localInitializationMethod: InitializationMethod = (
        InitializationMethod.Odometry
    )
    multirobotInitialization: bool = True
    acceleration: bool = False
    restartInterval: int = 30
    robustCostParams: RobustCostParameters = dataclasses.field(
        default_factory=RobustCostParameters
    )
    robustOptInnerIters: int = 30
    robustOptMinConvergenceRatio: float = 0.8
    robustOptNumWeightUpdates: int = 10
    robustOptNumResets: int = 0  # reference default (Agent.h:120)
    robustInitMinInliers: int = 2
    maxNumIters: int = 500
    relChangeTol: float = 5e-3
    localOptimizationParams: ROptParameters = dataclasses.field(
        default_factory=lambda: ROptParameters(
            gradnorm_tol=1e-2, RTR_iterations=3, RTR_tCG_iterations=50
        )
    )
    verbose: bool = False
    logData: bool = False
    logDirectory: str = ""

    @property
    def numRobots(self) -> int:
        return len(self.robotIDs)


class AgentState(enum.Enum):
    # reference: Agent.h:191-195
    WAIT_FOR_DATA = "WAIT_FOR_DATA"
    WAIT_FOR_INITIALIZATION = "WAIT_FOR_INITIALIZATION"
    INITIALIZED = "INITIALIZED"


@dataclasses.dataclass
class AgentStatus:
    """Gossiped agent status (reference: Agent.h:200-243)."""

    agentID: int = 0
    state: AgentState = AgentState.WAIT_FOR_DATA
    instanceNumber: int = 0
    iterationNumber: int = 0
    readyToTerminate: bool = False
    relativeChange: float = 0.0


@dataclasses.dataclass
class ROPTResult:
    """Result of one local optimization (reference: DCORA_types.h:203-233)."""

    success: bool = False
    fInit: float = 0.0
    fOpt: float = 0.0
    gradNormInit: float = 0.0
    gradNormOpt: float = 0.0
    elapsedMs: float = 0.0


@dataclasses.dataclass(frozen=True)
class ProblemDims:
    """Dimension bookkeeping: k = (d+1)n + l + b (reference: Graph.h:92)."""

    d: int  # ambient dimension, 2 or 3
    n: int  # number of poses
    l: int = 0  # number of unit-sphere (range) variables  # noqa: E741
    b: int = 0  # number of landmarks

    @property
    def k(self) -> int:
        return (self.d + 1) * self.n + self.l + self.b

    @property
    def num_trans(self) -> int:
        return self.n + self.b

    @property
    def rot_size(self) -> int:
        return self.d * self.n

    def __post_init__(self):
        assert self.d in (2, 3), f"d must be 2 or 3, got {self.d}"
