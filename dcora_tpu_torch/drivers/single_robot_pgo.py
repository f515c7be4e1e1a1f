"""Single-robot local PGO (mirrors examples/SingleRobotExample.cpp).

Counterpart of ``dcora_tpu.drivers.single_robot_pgo``: chordal
initialization followed by a Riemannian trust-region solve at rank d, or,
with --certify, the Riemannian staircase that certifies global optimality.

Usage: python -m dcora_tpu_torch.drivers.single_robot_pgo file.g2o
       [--certify] [--device cuda|cpu] [--log-dir DIR] [--r-max R]
       [--eta ETA] [--config FILE] [--set KEY=VALUE ...]
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional

import numpy as np

from dcora_tpu_torch.config import DcoraConfig, resolve
from dcora_tpu_torch.core import lifted, problem as prob
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import chordal_initialization
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.solvers import precond_build, resolve_device, solve_pgo
from dcora_tpu_torch.staircase import StaircaseResult, riemannian_staircase
from dcora_tpu_torch.types import ROptParameters
from dcora_tpu_torch.utils.logger import Logger
from dcora_tpu_torch.utils.timing import span


def run(g2o_path: str, certify: bool = False, log_directory: str = "",
        verbose: bool = True, opt_params: Optional[ROptParameters] = None,
        r_max: int = 20, eta: float = 1e-3, device: str = "cuda",
        result: Optional[dict] = None):
    """Solve one g2o file; returns (T_out [n, d, d+1], f).

    When `result` is a dict, the staircase result (StaircaseResult under
    "staircase"), the read/init/staircase wall times ("read_s", "init_s":
    the graph and the chordal init, "staircase_s") and which host builds
    ran ("reader" and "precond": "native" or "numpy") are stored into it.
    The certified solve's steps are spans "pgo.read", "pgo.graph",
    "pgo.init", "pgo.staircase" and "pgo.output"."""
    dev = resolve_device(device)
    with span("pgo.read") as read:
        ds = read_g2o_file(g2o_path)
    ms = ds.pose_pose_measurements
    d = ds.dim
    t0 = time.time()
    params = opt_params or ROptParameters(
        gradnorm_tol=1e-4, RTR_iterations=200, RTR_tCG_iterations=200)
    if certify:
        with span("pgo.graph") as graph:
            g = LocalGraph(0, d + 2, d)
            g.set_measurements(ms)
        with span("pgo.init") as init:
            T = chordal_initialization(ms, device=dev)
        with span("pgo.staircase"):
            X0 = lifted.pad_rank(lifted.from_pose_array(T, device=dev),
                                 d + 2)
            res: StaircaseResult = riemannian_staircase(
                g, X0, r_min=d + 2, r_max=min(r_max, 20),
                opt_params=params, min_eig_num_tol=eta)
        with span("pgo.output"):
            T_out = np.zeros((g.n, d, d + 1))
            T_out[:, :, :d] = res.rounded.rot.cpu().numpy()
            T_out[:, :, d] = res.rounded.trn.cpu().numpy()
            f = float(prob.cost(g.problem_data(device=dev), res.rounded))
        if result is not None:
            result.update(staircase=res, read_s=read.seconds,
                          init_s=graph.seconds + init.seconds,
                          staircase_s=res.elapsed_s, reader=ds.reader,
                          precond=precond_build())
        if verbose:
            print(f"solvePGO: certified={res.certified} "
                  f"rank={res.final_rank} f={f:.6f} "
                  f"elapsed={time.time() - t0:.1f}s")
    else:
        T_out = solve_pgo(ms, params, device=dev)
        g = LocalGraph(0, d, d)
        g.set_measurements(ms)
        f = float(prob.cost(g.problem_data(device=dev),
                            lifted.from_pose_array(T_out, device=dev)))
        if verbose:
            print(f"solvePGO: f={f:.6f} elapsed={time.time() - t0:.1f}s")
    if log_directory:
        Logger(log_directory).log_trajectory(d, len(T_out), T_out,
                                             "dcora_A.txt")
    return T_out, f


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("g2o")
    ap.add_argument("--certify", action="store_true")
    ap.add_argument("--log-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    ap.add_argument("--r-max", type=int, default=None,
                    help="highest staircase rank (default: "
                    "staircase.r_max, at most 20)")
    ap.add_argument("--eta", type=float, default=None,
                    help="certificate tolerance (default: "
                    "staircase.min_eig_num_tol)")
    DcoraConfig.add_cli(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = DcoraConfig.from_cli(args)
    logging.getLogger(__name__).info("config:\n%s", cfg.dump())
    return run(args.g2o, certify=args.certify, log_directory=args.log_dir,
               opt_params=cfg.ropt,
               r_max=resolve(args.r_max, cfg.staircase.r_max),
               eta=resolve(args.eta, cfg.staircase.min_eig_num_tol),
               device=args.device)


if __name__ == "__main__":
    main()
