"""Centralized CORA: single-robot RA-SLAM via the Riemannian staircase.

Counterpart of ``dcora_tpu.drivers.single_robot_raslam`` (mirrors
examples/SingleRobotExample_RASLAM.cpp): read PyFG, build the global RA
problem, odometry init aligned per robot to its ground-truth first pose +
ground-truth unit spheres + random landmarks, staircase r = d .. r_max with
certification, then rank-d rounding and refinement.

Usage: python -m dcora_tpu_torch.drivers.single_robot_raslam file.pyfg
       [--rmax 20] [--eta 1e-4] [--init odometry|ground_truth|random]
       [--device cuda|cpu] [--config FILE] [--set KEY=VALUE ...]
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional

import numpy as np
import torch

from dcora_tpu_torch.config import DcoraConfig, resolve
from dcora_tpu_torch.core import lifted, manifold, problem as prob
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import odometry_initialization
from dcora_tpu_torch.core.lifted import RAState, pose_inverse, pose_multiply
from dcora_tpu_torch.io import read_pyfg_file
from dcora_tpu_torch.io.remap import (
    get_global_measurements,
    get_local_to_global_state_mapping,
    get_robot_measurements,
)
from dcora_tpu_torch.measurements import RelativePosePoseMeasurement
from dcora_tpu_torch.solvers import precond_build, resolve_device
from dcora_tpu_torch.staircase import riemannian_staircase
from dcora_tpu_torch.types import MAP_ID, GraphType, PoseID, ROptParameters


def align_trajectory_to_frame(T: np.ndarray, Tw0: np.ndarray) -> np.ndarray:
    """T0i = Tw0^{-1} * Twi for every pose
    (reference: alignTrajectoryToFrame, DCORA_utils.cpp:2222-2235)."""
    inv = pose_inverse(Tw0)
    return np.stack([pose_multiply(inv, Ti) for Ti in T])


def odometry_init_global(ds, global_meas) -> RAState:
    """Per-robot odometry chained then aligned to the ground truth first
    pose; ground-truth unit spheres; random landmarks
    (reference: SingleRobotExample_RASLAM.cpp:88-152).  A host (CPU,
    float64) state."""
    mapping = get_local_to_global_state_mapping(ds)
    robot_meas = get_robot_measurements(ds)
    gt = global_meas.ground_truth_init
    d = ds.dim
    n, l, b = gt.n, gt.l, gt.b  # noqa: E741

    T = np.zeros((n, d, d + 1))
    for robot in sorted(ds.robot_IDs):
        if robot == MAP_ID:
            continue
        rm = robot_meas[robot]
        odo = [
            m
            for m in rm.relative_measurements
            if isinstance(m, RelativePosePoseMeasurement)
            and m.p1 + 1 == m.p2 and m.r1 == m.r2 == robot
        ]
        n_r = ds.robot_id_to_num_poses[robot]
        if not odo:
            Todo = np.zeros((n_r, d, d + 1))
            Todo[:, :, :d] = np.eye(d)
        else:
            Todo = odometry_initialization(odo)
        first_global = mapping.poses[PoseID(robot, 0)].frame_id
        Tw0 = np.concatenate(
            [gt.rot[first_global].numpy(),
             gt.trn[first_global].numpy()[:, None]], axis=1
        )
        # align odometry so its first pose coincides with ground truth:
        # the reference aligns with Tw0.inverse(), i.e. T_i <- Tw0 * T_i
        aligned = np.stack([pose_multiply(Tw0, Ti) for Ti in Todo])
        T[first_global:first_global + n_r] = aligned[:n_r]

    rng = np.random.default_rng(0)
    lmks = rng.uniform(-1, 1, size=(b, d))
    sphs = gt.sph.numpy()
    return lifted.from_pose_array(T, l=l, b=b, landmarks=lmks, spheres=sphs)


def run(pyfg_path: str, r_max: int = 20, min_eig_tol: float = 1e-4,
        init: str = "odometry", verbose: bool = True,
        checkpoint_path: Optional[str] = None, device: str = "cuda",
        result: Optional[dict] = None):
    """Certify one PyFG file on `device`; returns (StaircaseResult, graph,
    global measurements) like the JAX driver.

    When `result` is a dict, the staircase result (under "staircase"), the
    read and init wall times, the staircase wall time, the cost of the
    rounded solution ("f_rounded") and which host builds ran ("reader" and
    "precond": "native" or "numpy") are stored into it.  ``init="random"``
    draws from a torch.Generator seeded with 0 (the JAX driver's
    jax.random stream cannot be reproduced)."""
    dev = resolve_device(device)
    t0 = time.time()
    ds = read_pyfg_file(pyfg_path)
    gm = get_global_measurements(ds)
    d = ds.dim

    g = LocalGraph(0, d, d, GraphType.RangeAidedSLAMGraph)
    g.set_measurements(gm.relative_measurements)
    t_read = time.time() - t0

    if init == "odometry":
        X0 = odometry_init_global(ds, gm)
    elif init == "ground_truth":
        X0 = gm.ground_truth_init
    elif init == "random":
        X0 = manifold.random_state(g.dims, d, torch.Generator().manual_seed(0))
    else:
        raise ValueError(f"unknown init {init!r}")
    X0 = X0.to(dev)
    t_init = time.time() - t0 - t_read

    res = riemannian_staircase(
        g, X0, r_min=d, r_max=r_max,
        opt_params=ROptParameters(
            gradnorm_tol=1e-4, RTR_iterations=200, RTR_tCG_iterations=200
        ),
        min_eig_num_tol=min_eig_tol, verbose=verbose,
        checkpoint_path=checkpoint_path,
    )
    f_rounded = float(prob.cost(g.problem_data(device=dev), res.rounded))
    if result is not None:
        result.update(staircase=res, read_s=t_read, init_s=t_init,
                      staircase_s=res.elapsed_s, f_rounded=f_rounded,
                      reader=ds.reader, precond=precond_build())
    if verbose:
        print(
            f"CORA: certified={res.certified} rank={res.final_rank} "
            f"f={res.f_final:.6f} f_rounded={f_rounded:.6f} "
            f"elapsed={res.elapsed_s:.1f}s"
        )
    return res, g, gm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pyfg")
    ap.add_argument("--rmax", type=int, default=None,
                    help="highest staircase rank (default: 20)")
    ap.add_argument("--eta", type=float, default=None,
                    help="certificate tolerance (default: 1e-4)")
    ap.add_argument("--init", default="odometry",
                    choices=["odometry", "ground_truth", "random"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    DcoraConfig.add_cli(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = DcoraConfig.from_cli(args)
    logging.getLogger(__name__).info("config:\n%s", cfg.dump())
    # the centralized CORA demo's tolerance is 1e-4
    # (SingleRobotExample_RASLAM.cpp:77), tighter than the distributed
    # default carried by the config
    return run(args.pyfg, r_max=resolve(args.rmax,
                                        min(cfg.staircase.r_max, 20)),
               min_eig_tol=resolve(args.eta, 1e-4), init=args.init,
               device=args.device)


if __name__ == "__main__":
    main()
