"""Chordal initialization demo.

Counterpart of ``dcora_tpu.drivers.chordal_initialization_example`` (mirrors
examples/ChordalInitializationExample.cpp): the chordal relaxation on
`device` (the card unless the caller asks for the CPU) and its cost.

Usage: python -m dcora_tpu_torch.drivers.chordal_initialization_example
       file.g2o [--device cuda|cpu] [--log-dir DIR]
"""

from __future__ import annotations

import argparse
import time

from dcora_tpu_torch.core import lifted, problem as prob
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import chordal_initialization
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.solvers import resolve_device
from dcora_tpu_torch.utils.logger import Logger


def run(g2o_path: str, log_directory: str = "", verbose: bool = True,
        device="cuda"):
    """Returns (T [n, d, d+1], f)."""
    dev = resolve_device(device)
    ds = read_g2o_file(g2o_path)
    t0 = time.time()
    T = chordal_initialization(ds.pose_pose_measurements, device=dev)
    g = LocalGraph(0, ds.dim, ds.dim)
    g.set_measurements(ds.pose_pose_measurements)
    f = float(prob.cost(g.problem_data(device=dev),
                        lifted.from_pose_array(T, device=dev)))
    if verbose:
        print(
            f"chordal initialization: n={len(T)} f={f:.6f} "
            f"elapsed={time.time() - t0:.2f}s"
        )
    if log_directory:
        Logger(log_directory).log_trajectory(
            ds.dim, len(T), T, "chordal.txt"
        )
    return T, f


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("g2o")
    ap.add_argument("--log-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    args = ap.parse_args(argv)
    run(args.g2o, log_directory=args.log_dir, device=args.device)


if __name__ == "__main__":
    main()
