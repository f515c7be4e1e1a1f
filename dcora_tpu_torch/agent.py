"""Distributed agent: per-robot RBCD/RBCD++ state machine.

Counterpart of ``dcora_tpu.agent`` (reference: include/DCORA/Agent.h,
src/Agent.cpp): local initialization, global-frame alignment via robust
neighbor transforms, the RBCD(++) iterate with Nesterov acceleration and
periodic restart, public/neighbor state exchange, GNC measurement-weight
updates, and trajectory extraction.

Communication model: agents are plain objects and the "network" is direct
method calls exchanging state dicts (get_shared_state_dicts /
update_neighbor_states).  The payload schema matches Agent.cpp:113-195:
per-neighbor lifted pose blocks [r, d+1], unit-sphere and landmark columns
[r] (numpy on the host), plus the AgentStatus scalars and the one-time
lifting matrix.

The iterates live on the agent's device (the card unless the caller asks
for the CPU).  What the JAX package draws from ``jax.random`` is an input
here: the lifting matrix (``lifting_matrix``; by default
``manifold.fixed_lifting_matrix``, seeded), the Random local init (a
``torch.Generator`` seeded with the agent id, or ``initialize``'s
``trajectory_init``) and the asynchronous loop's exponential waits (a
``torch.Generator``; the JAX package's is an unseeded numpy generator).
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dcora_tpu_torch.core import lifted, manifold, problem as prob
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import (
    chordal_initialization,
    odometry_initialization,
)
from dcora_tpu_torch.core.lifted import (
    RAState,
    pose_identity,
    pose_inverse,
    pose_multiply,
)
from dcora_tpu_torch.core.robust import RobustCost
from dcora_tpu_torch.core.rtr import RTRConfig, TCGGraph, rgd_step, rtr
from dcora_tpu_torch.core.rtr import RA_BACKEND
from dcora_tpu_torch.measurements import RelativePosePoseMeasurement
from dcora_tpu_torch.solvers import (
    SolveRobustPGOParams,
    make_preconditioner,
    precond_reg,
    resolve_device,
    robust_single_rotation_averaging,
    single_translation_averaging,
    solve_robust_pgo,
)
from dcora_tpu_torch.types import (
    AgentParameters,
    AgentState,
    AgentStatus,
    GraphType,
    InitializationMethod,
    MAP_ID,
    PoseID,
    ROptMethod,
    ROptParameters,
    RobustCostParameters,
    RobustCostType,
    StateID,
)
from dcora_tpu_torch.utils.logger import Logger
from dcora_tpu_torch.utils.rotations import angular_to_chordal_so3

logger = logging.getLogger(__name__)


def update_Y(X: RAState, V: RAState, alpha: float) -> RAState:
    """Y = proj((1-alpha) X + alpha V)  (reference: Agent.cpp:1189-1205)."""
    return manifold.project(RAState(*((1 - alpha) * x + alpha * v
                                      for x, v in zip(X, V))))


def update_V(V: RAState, X: RAState, Y: RAState, gamma: float) -> RAState:
    """V = proj(V + gamma (X - Y))  (reference: Agent.cpp:1207-1214)."""
    return manifold.project(RAState(*(v + gamma * (x - y)
                                      for v, x, y in zip(V, X, Y))))


def max_translation_distance(X: RAState, Y: RAState) -> float:
    """max_i ||t_i - t'_i|| over poses (reference:
    LiftedArray::maxTranslationDistance)."""
    n = X.n
    if n == 0:
        return 0.0
    return float(torch.linalg.vector_norm(X.trn[:n] - Y.trn[:n],
                                          dim=1).max())


class Agent:
    """One robot (reference: Agent.h:245-...)."""

    def __init__(self, agent_id: int, params: AgentParameters,
                 device="cuda", lifting_matrix: Optional[np.ndarray] = None):
        self.id = agent_id
        self.params = params
        self.d = params.d
        self.r = params.r
        self.device = resolve_device(device)
        self.state = AgentState.WAIT_FOR_DATA
        self.status = AgentStatus(agent_id, self.state, 0, 0, False, 0.0)
        self.graph = LocalGraph(agent_id, self.r, self.d, params.graphType)
        self.robust_cost = RobustCost(params.robustCostParams)
        self.logger = Logger(params.logDirectory) if params.logData else None

        self.instance_number = 0
        self.iteration_number = 0
        self.latest_weight_update_iteration = 0
        self.robust_opt_inner_iter = 0
        self.weight_update_count = 0
        self.trajectory_reset_count = 0

        # iterates
        self.X: Optional[RAState] = None
        self.XInit: Optional[RAState] = None
        self.XPrev: Optional[RAState] = None
        # acceleration auxiliaries (reference: Agent.h gamma/alpha/Y/V)
        self.gamma = 0.0
        self.alpha = 0.0
        self.Y: Optional[RAState] = None
        self.V: Optional[RAState] = None

        self.YLift: Optional[np.ndarray] = None
        if agent_id == 0:
            self.set_lifting_matrix(
                lifting_matrix if lifting_matrix is not None
                else manifold.fixed_lifting_matrix(self.r, self.d).numpy())

        self.trajectory_local_init: Optional[np.ndarray] = None
        self.unit_sphere_local_init: Optional[np.ndarray] = None
        self.landmark_local_init: Optional[np.ndarray] = None
        self.global_anchor: Optional[np.ndarray] = None  # [r, d+1]

        # neighbor caches: StateID -> np arrays
        self.neighbor_pose_dict: Dict[StateID, np.ndarray] = {}
        self.neighbor_sphere_dict: Dict[StateID, np.ndarray] = {}
        self.neighbor_landmark_dict: Dict[StateID, np.ndarray] = {}
        self.neighbor_aux_pose_dict: Dict[StateID, np.ndarray] = {}
        self.neighbor_aux_sphere_dict: Dict[StateID, np.ndarray] = {}
        self.neighbor_aux_landmark_dict: Dict[StateID, np.ndarray] = {}
        self.team_status: Dict[int, AgentStatus] = {}
        self.team_robot_active: Dict[int, bool] = {
            rid: not self.is_agent_map(rid) for rid in params.robotIDs
        }
        self.local_opt_result = None
        # restricted problem, preconditioner and tCG graph, rebuilt when
        # the graph's version changes (weight updates, activity flips)
        self._cache_version = None
        self._host_X = (None, None, None)  # (X, rot, trn) host copy of X
        self._opt_thread: Optional[threading.Thread] = None
        self._opt_lock = threading.Lock()

    # ------------------------------------------------------------- helpers
    def is_agent_map(self, robot_id: Optional[int] = None) -> bool:
        rid = self.id if robot_id is None else robot_id
        return (rid == MAP_ID
                and self.params.graphType == GraphType.RangeAidedSLAMGraph)

    def is_pgo_compatible(self) -> bool:
        return self.graph.is_pgo_compatible()

    @property
    def num_poses(self) -> int:
        return self.graph.n

    @property
    def num_unit_spheres(self) -> int:
        return self.graph.l

    @property
    def num_landmarks(self) -> int:
        return self.graph.b

    def get_neighbors(self) -> List[int]:
        return sorted(self.graph.neighbor_ids())

    def _host_state(self):
        """(rot, trn) of X as host arrays, pulled once per iterate."""
        if self._host_X[0] is not self.X:
            self._host_X = (self.X, self.X.rot.cpu().numpy(),
                            self.X.trn.cpu().numpy())
        return self._host_X[1], self._host_X[2]

    # ------------------------------------------------------------ plumbing
    def set_lifting_matrix(self, M: np.ndarray):
        M = np.asarray(M, dtype=np.float64)
        assert M.shape == (self.r, self.d)
        self.YLift = M

    def get_lifting_matrix(self) -> Optional[np.ndarray]:
        return self.YLift

    def set_measurements(self, measurements: List[object]):
        assert self.state == AgentState.WAIT_FOR_DATA
        self.graph = LocalGraph(self.id, self.r, self.d,
                                self.params.graphType)
        self.graph.set_measurements(measurements)

    def set_X(self, X: RAState):
        """Directly set the iterate (reference: Agent::setX)."""
        assert self.state != AgentState.WAIT_FOR_DATA
        assert X.r == self.r
        X = X.to(self.device)
        self.state = AgentState.INITIALIZED
        self.X = X
        if self.XInit is None:
            # driver-provided iterate doubles as the robust-reset guess
            # when the agent skipped initialize_in_global_frame
            self.XInit = X
        if self.params.acceleration:
            self.initialize_acceleration()

    def set_X_matrix(self, M: np.ndarray):
        """Set from a reference-style SE interleaved matrix [r, (d+1)n]."""
        self.set_X(lifted.from_se_matrix(torch.as_tensor(M), self.d))

    def get_X(self) -> RAState:
        return self.X

    def set_X_to_initial_guess(self):
        assert self.XInit is not None
        self.X = self.XInit

    # -------------------------------------------------------- public states
    def get_shared_state_dicts(self, aux: bool = False):
        """Public lifted states (reference: Agent::getSharedStateDicts).

        Returns (pose_dict, sphere_dict, landmark_dict) mapping StateID ->
        np arrays ([r, d+1] poses; [r] spheres/landmarks), or None if not
        initialized.
        """
        if self.state != AgentState.INITIALIZED:
            return None
        X = self.Y if (aux and self.Y is not None) else self.X
        poses, spheres, landmarks = self.graph.my_public_state_ids()
        # one device->host copy per array, then per-pose slicing in numpy
        if X is self.X:
            rot, trn = self._host_state()
        else:
            rot, trn = X.rot.cpu().numpy(), X.trn.cpu().numpy()
        sph = X.sph.cpu().numpy() if spheres else None
        pose_dict = {
            sid: np.concatenate(
                [rot[sid.frame_id], trn[sid.frame_id][:, None]], axis=1
            )
            for sid in poses
        }
        sphere_dict = {sid: sph[sid.frame_id] for sid in spheres}
        landmark_dict = {
            sid: trn[self.graph.n + sid.frame_id] for sid in landmarks
        }
        return pose_dict, sphere_dict, landmark_dict

    def set_neighbor_status(self, status: AgentStatus):
        self.team_status[status.agentID] = status

    def get_status(self) -> AgentStatus:
        # refresh identity/state fields (reference: Agent.h:427-432)
        self.status.agentID = self.id
        self.status.state = self.state
        self.status.instanceNumber = self.instance_number
        self.status.iterationNumber = self.iteration_number
        return self.status

    def has_neighbor_status(self, rid: int) -> bool:
        return rid in self.team_status

    def get_neighbor_status(self, rid: int) -> AgentStatus:
        return self.team_status[rid]

    def update_neighbor_states(self, neighbor_id: int,
                               pose_dict: Dict[StateID, np.ndarray],
                               aux: bool = False,
                               sphere_dict=None, landmark_dict=None):
        """Cache neighbor public states; triggers global-frame init when
        waiting (reference: Agent.cpp:844-933)."""
        sphere_dict = sphere_dict or {}
        landmark_dict = landmark_dict or {}
        assert neighbor_id != self.id
        if self.YLift is None:
            return
        if not self.has_neighbor_status(neighbor_id):
            return
        if self.get_neighbor_status(neighbor_id).state != \
                AgentState.INITIALIZED:
            return
        if self.state == AgentState.WAIT_FOR_INITIALIZATION:
            T = self.compute_robust_neighbor_transform_two_stage(
                neighbor_id, pose_dict
            )
            if T is not None:
                self.initialize_in_global_frame(T)
        if self.state != AgentState.INITIALIZED:
            return
        pd = self.neighbor_aux_pose_dict if aux else self.neighbor_pose_dict
        sd = (self.neighbor_aux_sphere_dict if aux
              else self.neighbor_sphere_dict)
        ld = (self.neighbor_aux_landmark_dict if aux
              else self.neighbor_landmark_dict)
        for sid, val in pose_dict.items():
            if self.graph.requires_neighbor_pose(sid):
                pd[sid] = np.asarray(val)
        for sid, val in sphere_dict.items():
            if self.graph.requires_neighbor_sphere(sid):
                sd[sid] = np.asarray(val)
        for sid, val in landmark_dict.items():
            if self.graph.requires_neighbor_landmark(sid):
                ld[sid] = np.asarray(val)

    def clear_neighbor_states(self):
        self.neighbor_pose_dict.clear()
        self.neighbor_sphere_dict.clear()
        self.neighbor_landmark_dict.clear()
        self.neighbor_aux_pose_dict.clear()
        self.neighbor_aux_sphere_dict.clear()
        self.neighbor_aux_landmark_dict.clear()

    # -------------------------------------------------------------- init
    def initialize(self, trajectory_init: Optional[np.ndarray] = None,
                   unit_sphere_init: Optional[np.ndarray] = None,
                   landmark_init: Optional[np.ndarray] = None,
                   generator: Optional[torch.Generator] = None):
        """Local initialization (reference: Agent::initialize,
        Agent.cpp:256-458).  `generator` drives the Random method (default:
        a CPU generator seeded with the agent id)."""
        if self.state != AgentState.WAIT_FOR_DATA:
            return
        if self.num_poses == 0 and not self.is_agent_map():
            logger.info("agent %d: empty local graph", self.id)
            return

        d, n = self.d, self.num_poses
        if trajectory_init is not None and trajectory_init.shape == (
                n, d, d + 1):
            T = np.asarray(trajectory_init)
        elif self.is_agent_map():
            T = np.zeros((0, d, d + 1))
        else:
            method = self.params.localInitializationMethod
            if method == InitializationMethod.Odometry:
                T = odometry_initialization(self.graph.odometry)
            elif method == InitializationMethod.Chordal:
                assert self.is_pgo_compatible()
                T = chordal_initialization(self.graph.local_measurements(),
                                           device=self.device)
            elif method == InitializationMethod.Random:
                gen = generator if generator is not None else \
                    torch.Generator().manual_seed(self.id)
                Xr = manifold.random_state(self.graph.dims, d, gen)
                T = np.zeros((n, d, d + 1))
                T[:, :, :d] = Xr.rot.numpy()
                T[:, :, d] = Xr.trn[:n].numpy()
            elif method == InitializationMethod.GNC_TLS:
                assert self.is_pgo_compatible()
                T = self._gnc_tls_initialization()
            else:
                raise ValueError(method)
            if T.shape[0] != n:
                # odometry may not cover trailing poses; pad with identity
                T2 = np.zeros((n, d, d + 1))
                T2[:, :, :d] = np.eye(d)
                T2[: T.shape[0]] = T
                T = T2

        # unit spheres / landmarks (RA only)
        if not self.is_pgo_compatible():
            l, b = self.num_unit_spheres, self.num_landmarks  # noqa: E741
            if unit_sphere_init is not None and unit_sphere_init.shape == (
                    l, d):
                S = np.asarray(unit_sphere_init)
            else:
                rng = np.random.default_rng(self.id)
                S = rng.standard_normal((l, d))
                S /= np.maximum(
                    np.linalg.norm(S, axis=1, keepdims=True), 1e-12
                )
            if landmark_init is not None and landmark_init.shape == (b, d):
                L = np.asarray(landmark_init)
            else:
                rng = np.random.default_rng(self.id + 1000)
                L = rng.uniform(-1, 1, size=(b, d))
        else:
            S = np.zeros((0, d))
            L = np.zeros((0, d))

        # transform so the first pose is identity (reference:
        # Agent.cpp:425-440)
        if n > 0:
            Tw0 = T[0]
            inv = pose_inverse(Tw0)
            T = np.stack([pose_multiply(inv, Ti) for Ti in T])
            R0T = Tw0[:, :d].T
            S = (R0T @ S.T).T if len(S) else S
            L = ((R0T @ (L.T - Tw0[:, d:])).T) if len(L) else L

        self.trajectory_local_init = T
        self.unit_sphere_local_init = S
        self.landmark_local_init = L

        self.state = AgentState.WAIT_FOR_INITIALIZATION
        if (self.id == 0 or self.is_agent_map()
                or not self.params.multirobotInitialization):
            self.initialize_in_global_frame(pose_identity(d))

    def _gnc_tls_initialization(self) -> np.ndarray:
        """Robust local init (reference: Agent.cpp:379-418): solveRobustPGO
        on the local graph from odometry, on the agent's device; rejected
        loop closures keep weight 0."""
        params = SolveRobustPGOParams()
        params.opt_params = ROptParameters(
            gradnorm_tol=1.0, RTR_iterations=20
        )
        params.robust_params = RobustCostParameters(
            costType=RobustCostType.GNC_TLS, GNCMaxNumIters=10,
            GNCBarc=5.0, GNCMuStep=1.4,
        )
        T_odom = odometry_initialization(self.graph.odometry)
        local = [copy.copy(m) for m in self.graph.local_measurements()]
        T = solve_robust_pgo(local, params, T_odom, device=self.device)
        reject = 0
        for m in local:
            if m.weight < 1e-8:
                self.set_measurement_weight(m.edge_id(), 0.0)
                reject += 1
        logger.info("agent %d: GNC_TLS init rejects %d local loop closures",
                    self.id, reject)
        return T

    def initialize_in_global_frame(self, T_world_robot: np.ndarray):
        """Apply a global transform and lift (reference:
        Agent::initializeInGlobalFrame, Agent.cpp:460-533)."""
        assert self.YLift is not None
        d, n = self.d, self.num_poses
        self.clear_neighbor_states()

        T = self.trajectory_local_init
        S = self.unit_sphere_local_init
        L = self.landmark_local_init
        # align trajectory: T_i <- T_world_robot * T_i
        Tg = (np.stack([pose_multiply(T_world_robot, Ti) for Ti in T])
              if n else T)
        R0 = T_world_robot[:, :d]
        Sg = (R0 @ S.T).T if len(S) else S
        Lg = ((R0 @ L.T).T + T_world_robot[:, d]) if len(L) else L

        X_global = lifted.from_pose_array(
            Tg, l=len(Sg), b=len(Lg), landmarks=Lg, spheres=Sg,
            device=self.device)
        self.X = lifted.lift(X_global, torch.as_tensor(
            self.YLift, dtype=torch.float64, device=self.device))
        self.XInit = self.X
        if self.state == AgentState.INITIALIZED:
            logger.info("agent %d re-initializes in global frame", self.id)
        else:
            logger.info("agent %d initializes in global frame", self.id)
            self.state = AgentState.INITIALIZED
        if self.params.robustCostParams.costType != RobustCostType.L2:
            self.initialize_robust_optimization()
        if self.params.acceleration:
            self.initialize_acceleration()
        if self.logger and not self.is_agent_map() and n:
            self.logger.log_trajectory(
                d, n, Tg, f"dcora_{chr(ord('A') + self.id)}_initial.txt"
            )

    # ---------------------------------------- robust neighbor transform
    def compute_neighbor_transform(self, m: RelativePosePoseMeasurement,
                                   neighbor_pose: np.ndarray) -> np.ndarray:
        """Candidate world alignment from one shared loop closure
        (reference: Agent.cpp:694-729)."""
        d = self.d
        dT = np.zeros((d, d + 1))
        dT[:, :d] = m.R
        dT[:, d] = m.t
        T_w2_f2 = self.YLift.T @ np.asarray(neighbor_pose)  # [d, d+1]
        T = self.trajectory_local_init
        if m.r2 == self.id:
            T_f1_f2 = pose_inverse(dT)
            T_w1_f1 = T[m.p2]
        else:
            T_f1_f2 = dT
            T_w1_f1 = T[m.p1]
        T_w2_f1 = pose_multiply(T_w2_f2, pose_inverse(T_f1_f2))
        return pose_multiply(T_w2_f1, pose_inverse(T_w1_f1))

    def compute_robust_neighbor_transform_two_stage(
        self, neighbor_id: int, pose_dict: Dict[StateID, np.ndarray]
    ) -> Optional[np.ndarray]:
        """Robust rotation averaging then translation averaging over inlier
        loop closures (reference: Agent.cpp:731-842)."""
        RVec, tVec = [], []
        for m in self.graph.shared_loop_closures_with_robot(neighbor_id):
            if not isinstance(m, RelativePosePoseMeasurement):
                continue
            nbr_pid = (PoseID(neighbor_id, m.p1) if m.r1 == neighbor_id
                       else PoseID(neighbor_id, m.p2))
            if nbr_pid not in pose_dict:
                continue
            T = self.compute_neighbor_transform(m, pose_dict[nbr_pid])
            RVec.append(T[:, : self.d])
            tVec.append(T[:, self.d])
        if not RVec:
            return None
        max_rot_err = angular_to_chordal_so3(0.5)  # ~30 deg
        ROpt, inliers = robust_single_rotation_averaging(
            RVec, np.ones(len(RVec)), max_rot_err
        )
        logger.info(
            "agent %d init from neighbor %d: %d/%d inliers",
            self.id, neighbor_id, len(inliers), len(RVec),
        )
        if len(inliers) < self.params.robustInitMinInliers:
            return None
        tOpt = single_translation_averaging([tVec[i] for i in inliers])
        T = np.zeros((self.d, self.d + 1))
        T[:, : self.d] = ROpt
        T[:, self.d] = tOpt
        return T

    # ------------------------------------------------------------ iterate
    def iterate(self, do_optimization: bool) -> bool:
        """One RBCD(++) iteration (reference: Agent::iterate,
        Agent.cpp:535-596)."""
        self.iteration_number += 1
        if self.params.robustCostParams.costType != RobustCostType.L2:
            self.robust_opt_inner_iter += 1
        if self.state != AgentState.INITIALIZED or self.is_agent_map():
            return True

        self.XPrev = self.X
        if self.params.acceleration:
            self.update_gamma()
            self.update_alpha()
            self.update_Y()
            success = self.update_X(do_optimization, acceleration=True)
            self.update_V()
            if self.should_restart():
                self.restart_nesterov_acceleration(do_optimization)
        else:
            success = self.update_X(do_optimization, acceleration=False)

        if do_optimization:
            self.status.agentID = self.id
            self.status.state = self.state
            self.status.instanceNumber = self.instance_number
            self.status.iterationNumber = self.iteration_number
            self.status.relativeChange = max_translation_distance(
                self.X, self.XPrev
            )
            ready = success
            rel_tol = self.params.relChangeTol
            if (self.params.robustCostParams.costType != RobustCostType.L2
                    and self.weight_update_count == 0):
                rel_tol = 5.0
            if self.status.relativeChange > rel_tol:
                ready = False
            stat = self.graph.statistics()
            total = max(stat.total_loop_closures, 1e-9)
            ratio = (stat.accept_loop_closures
                     + stat.reject_loop_closures) / total
            if stat.total_loop_closures > 0 and \
                    ratio < self.params.robustOptMinConvergenceRatio:
                ready = False
            self.status.readyToTerminate = ready
        return success

    def _refresh_cache(self):
        """The SoA, the restricted operator, the preconditioner and the tCG
        graph, across iterations; only weight updates and activity flips
        (the graph's version) invalidate them."""
        if self._cache_version == self.graph.version:
            return
        self._cached_P = self.graph.problem_data(device=self.device)
        self._cached_P_local = pad_problem_for_local(self._cached_P,
                                                     self.graph)
        # the regularizer's power iteration runs on the local block (the
        # JAX package's gathers clamp the neighbor slots onto the zero pad
        # and its segment sums drop them, which is what the remap does)
        g = self.graph
        self._cached_M = make_preconditioner(
            g, self._cached_P, precond_reg(g, self._cached_P_local))
        self._cached_graph = None
        self._cache_version = self.graph.version

    def local_problem(self, acceleration: bool = False):
        """(P_local, G, M, X0) of the restricted problem update_X solves,
        or None when a neighbor's state is missing."""
        if acceleration:
            pd, sd, ld = (self.neighbor_aux_pose_dict,
                          self.neighbor_aux_sphere_dict,
                          self.neighbor_aux_landmark_dict)
        else:
            pd, sd, ld = (self.neighbor_pose_dict,
                          self.neighbor_sphere_dict,
                          self.neighbor_landmark_dict)
        X_fixed, all_present = self.graph.fixed_state(pd, sd, ld,
                                                      device=self.device)
        if not all_present:
            return None
        self._refresh_cache()
        n, l, nt = self.graph.n, self.graph.l, self.graph.n + self.graph.b
        G = prob.linear_term(self._cached_P, X_fixed, n, l, nt)
        if G is None:
            G = lifted.zeros(self.graph.dims, self.r, device=self.device)
        X0 = self.Y if acceleration else self.X
        return self._cached_P_local, G, self._cached_M, X0

    def update_X(self, do_optimization: bool, acceleration: bool) -> bool:
        """Build the local subproblem and run the one-accepted-step RTR
        (reference: Agent::updateX, Agent.cpp:1216-1278)."""
        if not do_optimization:
            if acceleration:
                self.X = self.Y
            return True
        assert self.state == AgentState.INITIALIZED

        local = self.local_problem(acceleration)
        if local is None:
            logger.warning(
                "agent %d: missing neighbor states, skip optimization",
                self.id,
            )
            return False
        P, G, M, X0 = local
        opt = self.params.localOptimizationParams
        if opt.method == ROptMethod.RGD:
            # single preconditioned Riemannian gradient step (reference:
            # QuadraticOptimizer.cpp:110-180, selected via ROptMethod::RGD)
            self.X = rgd_step(P, G, M if opt.RGD_use_preconditioner
                              else None, X0, opt.RGD_stepsize)
            self.local_opt_result = None
            return True
        # One-accepted-step trust region (the reference's Max_Iteration==1
        # radius-shrink path, QuadraticOptimizer.cpp:254-280), as the JAX
        # package runs it (see dcora_tpu/agent.py for why not multi-outer).
        cfg = RTRConfig(
            gradnorm_tol=opt.gradnorm_tol,
            max_inner=opt.RTR_tCG_iterations,
            initial_radius=opt.RTR_initial_radius,
            single_accepted_step=True,
        )
        # on the card the tCG graph is captured once per cached problem
        if self.device.type == "cuda" and (
                self._cached_graph is None
                or self._cached_graph.max_inner != cfg.max_inner):
            self._cached_graph = TCGGraph(RA_BACKEND, P, M, cfg.max_inner)
        res = rtr(P, G, M, X0, cfg, graph=self._cached_graph)
        self.X = res.X
        self.local_opt_result = res
        return True

    # ------------------------------------------------------- acceleration
    def initialize_acceleration(self):
        if self.state == AgentState.INITIALIZED:
            self.XPrev = self.X
            self.gamma = 0.0
            self.alpha = 0.0
            self.V = self.X
            self.Y = self.X

    def update_gamma(self):
        N = self.params.numRobots
        self.gamma = (1 + np.sqrt(1 + 4 * N**2 * self.gamma**2)) / (2 * N)

    def update_alpha(self):
        self.alpha = 1.0 / (self.gamma * self.params.numRobots)

    def update_Y(self):
        self.Y = update_Y(self.X, self.V, self.alpha)

    def update_V(self):
        self.V = update_V(self.V, self.X, self.Y, self.gamma)

    def should_restart(self) -> bool:
        if self.params.acceleration:
            return (self.iteration_number + 1) % \
                self.params.restartInterval == 0
        return False

    def restart_nesterov_acceleration(self, do_optimization: bool):
        if self.params.acceleration and \
                self.state == AgentState.INITIALIZED:
            self.X = self.XPrev
            self.update_X(do_optimization, acceleration=False)
            self.V = self.X
            self.Y = self.X
            self.gamma = 0.0
            self.alpha = 0.0

    # ------------------------------------------------------- async mode
    def start_optimization_loop(self,
                                generator: Optional[torch.Generator] = None):
        """Spawn the asynchronous optimization thread firing at
        exponential-distributed intervals (reference: Agent.cpp:650-692),
        drawn from `generator` (default: seeded with the agent id).
        Asynchronous mode excludes acceleration, as in the reference."""
        assert not self.params.acceleration, (
            "asynchronous mode does not support acceleration"
        )
        if self.is_optimization_running():
            return
        self._end_loop_requested = False
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(self.id)
        rate = self.params.asynchronousOptimizationRate

        def loop():
            while not self._end_loop_requested:
                with self._opt_lock:
                    self.iterate(True)
                wait = torch.empty((), dtype=torch.float64).exponential_(
                    rate, generator=gen)
                time.sleep(float(wait))

        self._opt_thread = threading.Thread(target=loop, daemon=True)
        self._opt_thread.start()

    def end_optimization_loop(self):
        if not self.is_optimization_running():
            return
        self._end_loop_requested = True
        self._opt_thread.join()
        self._opt_thread = None

    def is_optimization_running(self) -> bool:
        return self._opt_thread is not None and self._opt_thread.is_alive()

    # ------------------------------------------------------------- robust
    def initialize_robust_optimization(self):
        self.robust_cost.reset()
        for m in self.graph.active_loop_closures():
            if not m.fixedWeight:
                m.weight = 1.0
        self.graph._invalidate()

    def compute_measurement_residual(
        self, m: RelativePosePoseMeasurement
    ) -> Optional[float]:
        """sqrt of the weighted squared error at the current lifted estimate
        (reference: Agent.cpp:1341-1397)."""
        if self.state != AgentState.INITIALIZED:
            return None
        rot, trn = self._host_state()

        def own(p):
            return rot[p], trn[p]

        if m.r1 == m.r2:
            Y1, p1 = own(m.p1)
            Y2, p2 = own(m.p2)
        elif m.r1 == self.id:
            Y1, p1 = own(m.p1)
            nid = PoseID(m.r2, m.p2)
            if nid not in self.neighbor_pose_dict:
                return None
            P2 = self.neighbor_pose_dict[nid]
            Y2, p2 = P2[:, : self.d], P2[:, self.d]
        else:
            Y2, p2 = own(m.p2)
            nid = PoseID(m.r1, m.p1)
            if nid not in self.neighbor_pose_dict:
                return None
            P1 = self.neighbor_pose_dict[nid]
            Y1, p1 = P1[:, : self.d], P1[:, self.d]
        err = (m.kappa * float(((Y1 @ m.R - Y2) ** 2).sum())
               + m.tau * float(((p2 - p1 - Y1 @ m.t) ** 2).sum()))
        return float(np.sqrt(err))

    def should_update_measurement_weights(self) -> bool:
        """reference: Agent.cpp:1280-1339."""
        if self.params.robustCostParams.costType == RobustCostType.L2:
            return False
        if self.weight_update_count >= self.params.robustOptNumWeightUpdates:
            return False
        if self.robust_opt_inner_iter >= self.params.robustOptInnerIters:
            return True
        for rid in self.params.robotIDs:
            if not self.is_robot_active(rid):
                continue
            st = self.team_status.get(rid)
            if st is None:
                return False
            if st.iterationNumber < self.latest_weight_update_iteration:
                return False
            if st.state != AgentState.INITIALIZED:
                return False
            if not st.readyToTerminate:
                return False
        return True

    def _robust_loop_closures(self):
        return [m for m in self.graph.active_loop_closures()
                if not m.fixedWeight
                and isinstance(m, RelativePosePoseMeasurement)]

    def update_measurement_weights(self):
        """reference: Agent.cpp:1399-1454."""
        if self.state != AgentState.INITIALIZED:
            return
        for m in self._robust_loop_closures():
            resid = self.compute_measurement_residual(m)
            if resid is not None:
                m.weight = float(self.robust_cost.weight(resid))
        self.weight_update_count += 1
        self.latest_weight_update_iteration = self.iteration_number
        self.robust_opt_inner_iter = 0
        self.graph._invalidate()
        self.robust_cost.update()
        self.team_status.clear()
        self.status.readyToTerminate = False
        self.status.relativeChange = 0.0
        if self.trajectory_reset_count < self.params.robustOptNumResets:
            self.trajectory_reset_count += 1
            logger.info("agent %d resets trajectory after weight update",
                        self.id)
            self.set_X_to_initial_guess()
            self.clear_neighbor_states()
        if self.params.acceleration:
            self.initialize_acceleration()

    def reclassify_measurement_weights(self, w_change_tol: float = 1e-3
                                       ) -> int:
        """Recompute GNC weights from the current residuals at the current
        mu without advancing the schedule, counters or statuses; returns
        the number of weights that changed by more than ``w_change_tol``.
        The terminal repair pass of the distributed pipeline (see
        dcora_tpu/agent.py for the measurements that motivated it)."""
        if self.state != AgentState.INITIALIZED:
            return 0
        changed = 0
        for m in self._robust_loop_closures():
            resid = self.compute_measurement_residual(m)
            if resid is None:
                continue
            w = float(self.robust_cost.weight(resid))
            if abs(w - m.weight) > w_change_tol:
                m.weight = w
                changed += 1
        if changed:
            self.graph._invalidate()
        return changed

    def max_measurement_residual(self):
        """Max unweighted residual over the active non-fixed loop closures:
        the driver's adaptive GNC mu init takes the team-wide max, as the
        central loop's mu = barc^2 / (2 max r^2 - barc^2)
        (DCORA_solver.cpp:349-357)."""
        best = None
        for m in self._robust_loop_closures():
            r = self.compute_measurement_residual(m)
            if r is not None:
                best = r if best is None else max(best, r)
        return best

    def num_undecided_measurements(self, w_tol: float = 1e-8) -> int:
        """Loop closures whose GNC weight is neither accepted (~1) nor
        rejected (~0) (the central loop stops on zero of them,
        DCORA_solver.cpp:366-405)."""
        return sum(1 for m in self._robust_loop_closures()
                   if w_tol <= m.weight <= 1 - w_tol)

    def set_gnc_mu(self, mu: float, reset_schedule: bool = False):
        """Override the GNC control parameter (every agent must share one mu
        for the weights to agree on shared edges).  ``reset_schedule``
        zeroes the mu-update counter so a re-annealing pass can ramp mu
        again."""
        self.robust_cost.mu = float(mu)
        if reset_schedule:
            self.robust_cost._gnc_iteration = 0

    def set_measurement_weight(self, edge_id, weight: float,
                               fixed_weight: bool = False) -> bool:
        m = self.graph.find_measurement(edge_id)
        if m is None:
            return False
        m.weight = weight
        m.fixedWeight = fixed_weight
        self.graph._invalidate()
        return True

    # --------------------------------------------------------- robot masks
    def is_robot_active(self, rid: int) -> bool:
        return self.team_robot_active.get(rid, False)

    def set_robot_active(self, rid: int, active: bool = True):
        if self.is_agent_map(rid):
            return
        self.team_robot_active[rid] = active
        if self.graph.has_neighbor(rid):
            self.graph.set_neighbor_active(rid, active)

    def num_active_robots(self) -> int:
        return sum(bool(v) for v in self.team_robot_active.values())

    # --------------------------------------------------------- termination
    def should_terminate(self) -> bool:
        """reference: Agent.cpp:1123-1156."""
        if self.iteration_number >= self.params.maxNumIters:
            return True
        if self.params.robustCostParams.costType != RobustCostType.L2:
            if self.weight_update_count < \
                    self.params.robustOptNumWeightUpdates:
                return False
        for rid in self.params.robotIDs:
            if not self.is_robot_active(rid):
                continue
            if rid == self.id:
                st = self.status
            else:
                st = self.team_status.get(rid)
            if st is None or st.state != AgentState.INITIALIZED:
                return False
            if not st.readyToTerminate:
                return False
        return True

    # -------------------------------------------------------------- anchor
    def set_global_anchor(self, M: np.ndarray):
        assert M.shape == (self.r, self.d + 1)
        self.global_anchor = np.asarray(M)

    def anchor_first_pose(self, prior: Optional[np.ndarray] = None):
        if prior is not None:
            self.graph.set_prior(0, prior)
            return True
        if self.num_poses == 0:
            return False
        self.graph.set_prior(0, self.X.pose(0).cpu().numpy())
        return True

    # ---------------------------------------------------------- extraction
    def get_trajectory_in_global_frame(self) -> Optional[np.ndarray]:
        """Round the lifted trajectory against the global anchor
        (reference: Agent.cpp:1016-1040, alignLiftedTrajectoryToFrame
        DCORA_utils.cpp:2256-2289)."""
        if self.global_anchor is None or \
                self.state != AgentState.INITIALIZED:
            return None
        return self._align_lifted_trajectory(self.global_anchor,
                                             global_alignment=True)

    def get_trajectory_in_local_frame(self) -> Optional[np.ndarray]:
        if self.state != AgentState.INITIALIZED:
            return None
        anchor = self.X.pose(0).cpu().numpy()
        return self._align_lifted_trajectory(anchor, global_alignment=False)

    def _align_lifted_trajectory(self, anchor: np.ndarray,
                                 global_alignment: bool) -> np.ndarray:
        d, n = self.d, self.num_poses
        rot_h, trn_h = self._host_state()
        R0T = anchor[:, :d].T  # [d, r]
        rot = np.einsum("dr,nre->nde", R0T, rot_h)
        trn = (R0T @ trn_h[:n].T).T  # [n, d]
        ta = anchor[:, d] if global_alignment else trn_h[0]
        t0 = R0T @ ta
        T = np.zeros((n, d, d + 1))
        T[:, :, :d] = manifold.rotation_project(
            torch.as_tensor(rot, dtype=torch.float64)).numpy()
        T[:, :, d] = trn - t0
        return T

    def _states_in_frame(self, anchor: np.ndarray, t_anchor: np.ndarray,
                         global_alignment: bool):
        d, n = self.d, self.num_poses
        R0T = anchor[:, :d].T
        T = self._align_lifted_trajectory(anchor, global_alignment)
        t0 = R0T @ t_anchor
        _, trn_h = self._host_state()
        S = (R0T @ self.X.sph.cpu().numpy().T).T if self.num_unit_spheres \
            else np.zeros((0, d))
        L = ((R0T @ trn_h[n:].T).T - t0) if self.num_landmarks \
            else np.zeros((0, d))
        return T, S, L

    def get_states_in_local_frame(self):
        """(trajectory, unit_spheres, landmarks) rounded in the local frame
        anchored at pose 0 (reference: Agent::getStatesInLocalFrame,
        Agent.cpp:956-1014)."""
        if self.state != AgentState.INITIALIZED:
            return None
        anchor = self.X.pose(0).cpu().numpy()
        return self._states_in_frame(anchor, self._host_state()[1][0],
                                     global_alignment=False)

    def get_states_in_global_frame(self):
        """(trajectory, unit_spheres, landmarks) rounded in global frame."""
        if self.global_anchor is None or \
                self.state != AgentState.INITIALIZED:
            return None
        anchor = self.global_anchor
        return self._states_in_frame(anchor, anchor[:, self.d],
                                     global_alignment=True)

    # --------------------------------------------------------------- reset
    def reset(self):
        """reference: Agent::reset (Agent.cpp:598-648)."""
        if self.logger is not None:
            self.logger.log_measurements(
                self.graph.all_measurements(), "measurements.txt"
            )
            if not self.is_agent_map():
                T = self.get_trajectory_in_global_frame()
                if T is not None:
                    self.logger.log_trajectory(
                        self.d, self.num_poses, T,
                        f"dcora_{chr(ord('A') + self.id)}.txt",
                    )
        self.instance_number += 1
        self.iteration_number = 0
        self.latest_weight_update_iteration = 0
        self.robust_opt_inner_iter = 0
        self.weight_update_count = 0
        self.trajectory_reset_count = 0
        self.state = AgentState.WAIT_FOR_DATA
        self.status = AgentStatus(
            self.id, self.state, self.instance_number, 0, False, 0.0
        )
        self.team_status.clear()
        for rid in self.params.robotIDs:
            self.team_robot_active[rid] = False
        self.global_anchor = None
        self.trajectory_local_init = None
        self.unit_sphere_local_init = None
        self.landmark_local_init = None
        self.XInit = None
        for nbr in self.graph.neighbor_ids():
            self.graph.set_neighbor_active(nbr, True)
        self.clear_neighbor_states()


def pad_problem_for_local(P: prob.ProblemData,
                          graph: LocalGraph) -> prob.ProblemData:
    """Remap fixed-neighbor slot indices (>= local sizes) onto apply_Q's
    implicit zero-padding slot (== local size), turning the augmented SoA
    into the local Q_bb block operator (see problem.apply_Q)."""
    n, b, l = graph.n, graph.b, graph.l  # noqa: E741
    nt = n + b

    def remap(idx, limit):
        return torch.clamp(idx, max=limit)

    return prob.with_segments(P._replace(
        pp_ri=remap(P.pp_ri, n), pp_rj=remap(P.pp_rj, n),
        pp_ti=remap(P.pp_ti, nt), pp_tj=remap(P.pp_tj, nt),
        pl_ri=remap(P.pl_ri, n),
        pl_ti=remap(P.pl_ti, nt), pl_tj=remap(P.pl_tj, nt),
        rg_ti=remap(P.rg_ti, nt), rg_tj=remap(P.rg_tj, nt),
        rg_q=remap(P.rg_q, l),
    ))
