"""Robust single-robot PGO with GNC-TLS.

Counterpart of ``dcora_tpu.drivers.single_robot_gnc`` (mirrors
examples/SingleRobotGNCExample.cpp): solveRobustPGO on one g2o file, each
GNC stage a full solve_pgo on `device` (the card unless the caller asks for
the CPU).

Usage: python -m dcora_tpu_torch.drivers.single_robot_gnc file.g2o
       [--device cuda|cpu] [--log-dir DIR] [--gnc-barc 5.0]
       [--config FILE] [--set KEY=VALUE ...]
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional

from dcora_tpu_torch.config import DcoraConfig, resolve
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.solvers import (
    SolveRobustPGOParams,
    resolve_device,
    solve_robust_pgo,
)
from dcora_tpu_torch.types import (
    ROptParameters,
    RobustCostParameters,
    RobustCostType,
)
from dcora_tpu_torch.utils.logger import Logger


def run(g2o_path: str, log_directory: str = "", verbose: bool = True,
        robust_params: Optional[RobustCostParameters] = None,
        device="cuda", measurements=None, stats: Optional[list] = None):
    """Returns (T [n, d, d+1], measurements with their final weights).
    `measurements` replaces the file's (a corrupted copy, for example);
    `stats` collects solve_pgo's per-stage seconds (solve_robust_pgo)."""
    dev = resolve_device(device)
    ds = read_g2o_file(g2o_path)
    ms = list(measurements if measurements is not None
              else ds.pose_pose_measurements)
    t0 = time.time()
    rp = robust_params or RobustCostParameters(
        costType=RobustCostType.GNC_TLS
    )
    rp.costType = RobustCostType.GNC_TLS
    params = SolveRobustPGOParams(
        opt_params=ROptParameters(gradnorm_tol=1e-2, RTR_iterations=50),
        robust_params=rp,
        verbose=verbose,
    )
    T = solve_robust_pgo(ms, params, device=dev, stats=stats)
    rejected = sum(1 for m in ms if not m.fixedWeight and m.weight < 1e-8)
    loop_closures = sum(1 for m in ms if not m.fixedWeight)
    if verbose:
        print(
            f"solveRobustPGO: rejected {rejected}/{loop_closures} loop "
            f"closures, elapsed={time.time() - t0:.1f}s"
        )
    if log_directory:
        Logger(log_directory).log_trajectory(
            ds.dim, len(T), T, "dcora_gnc.txt"
        )
        Logger(log_directory).log_measurements(ms, "measurements.txt")
    return T, ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("g2o")
    ap.add_argument("--log-dir", default="")
    ap.add_argument("--gnc-barc", type=float, default=None,
                    help="GNC barc (default: robust.GNCBarc, 5.0)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    DcoraConfig.add_cli(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = DcoraConfig.from_cli(args)
    logging.getLogger(__name__).info("config:\n%s", cfg.dump())
    rp = cfg.robust
    rp.GNCBarc = resolve(args.gnc_barc, rp.GNCBarc)
    return run(args.g2o, log_directory=args.log_dir, device=args.device,
               robust_params=rp)


if __name__ == "__main__":
    main()
