"""``spmm_bench`` of two source trees in turns, on one CUDA device.

    python -m dcora_tpu_torch.tools.spmm_ab OTHER_TREE [--out DIR]
        [--dtypes float32 float64] [--rank 5]

Compares this tree's SpMM kernels with another checkout's (for instance
the parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Per dtype it runs ``python -m
dcora_tpu_torch.tools.spmm_bench`` four times, each in a process of its
own started from that tree's root, in the turns other, this, this, other,
all on the same generated 10,648-pose grid.  Each run's JSON and output go
to ``DIR/ab_<dtype>_<turn>_<side>.{json,txt}``; each kernel row's device
ms, event ms and MB of Q are printed.  A run that fails is reported and
the turns go on; the exit code is then 1.  Compare the two sides only
within one call: the card's clocks and the host differ between machines.
Refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from dcora_tpu_torch.tools import common

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TURNS = ("other", "this", "this", "other")


def run(other: str, out: str, dtypes=("float32", "float64"), rank: int = 5):
    """Run the turns; returns {(dtype, turn, side): spmm_bench result, or
    None where that run failed}."""
    common.require_cuda("spmm_ab")
    os.makedirs(out, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    trees = {"other": os.path.abspath(other), "this": HERE}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        grid = common.default_grid(tmp)
        for dt in dtypes:
            for turn, side in enumerate(TURNS, 1):
                stem = os.path.join(out, f"ab_{dt}_{turn}_{side}")
                with open(stem + ".txt", "w") as log:
                    rc = subprocess.run(
                        [sys.executable, "-m",
                         "dcora_tpu_torch.tools.spmm_bench", grid,
                         "--dtype", dt, "--rank", str(rank),
                         "--out", stem + ".json"],
                        cwd=trees[side], env=env, stdout=log,
                        stderr=subprocess.STDOUT).returncode
                if rc != 0:
                    results[(dt, turn, side)] = None
                    print(f"== {dt} turn {turn} ({side}): FAILED, rc {rc} "
                          f"(see {stem}.txt)")
                    continue
                with open(stem + ".json") as fh:
                    res = json.load(fh)
                results[(dt, turn, side)] = res
                print(f"== {dt} turn {turn} ({side}): {res['nvidia_smi']}")
                for row in res["rows"]:
                    # older trees name the MB column streamed_mb
                    mb = row.get("q_mb", row.get("streamed_mb", 0.0))
                    print(f"  {row['label']:40s} device {row['device_ms']:.4f}"
                          f" ms  event {row['ms']:.4f} ms  {mb:7.2f} MB of Q")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other source tree")
    ap.add_argument("--out", default="chiprun_out/spmm_ab")
    ap.add_argument("--dtypes", nargs="+", default=["float32", "float64"],
                    choices=("float32", "float64"))
    ap.add_argument("--rank", type=int, default=5)
    args = ap.parse_args(argv)
    results = run(args.other, args.out, tuple(args.dtypes), args.rank)
    return int(any(r is None for r in results.values()))


if __name__ == "__main__":
    raise SystemExit(main())
