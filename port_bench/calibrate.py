"""The readings the comparison's limits are set from, in one process: a
short run of a cell on each of a dozen or more seeds, then its control
(port_bench/control.py) on three or more.

    python3 port_bench/calibrate.py --workload grid3d.tiles \
        --seeds 11 12 ... --control-seeds 21 22 23 [--seconds 1]

Each line printed is one run's JSON: the seed, whether it was the
control, and the numbers compared with the limits they are held to now.
No warm-up solve: nothing here is timed.  Refuses to run without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from contextlib import nullcontext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from port_bench import run

    run.environment()
    import torch

    from port_bench import control, harness

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload, ROOT)
    runs = [(s, False) for s in args.seeds] + \
        [(s, True) for s in args.control_seeds]
    for seed, is_control in runs:
        tmp = tempfile.mkdtemp(prefix="port_bench_calibrate_")
        t0 = time.perf_counter()
        try:
            with control.control_of(cell) if is_control else nullcontext():
                out = harness.run_cell(cell, seed, args.seconds, False,
                                       "cuda", tmp, t0, warmup=False)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": is_control, "correct": out["correct"],
                          "solves": out["attempted"],
                          "seconds": time.perf_counter() - t0,
                          "readings": out["readings"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
