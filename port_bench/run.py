"""Run one cell of the port's benchmark once and print one JSON line.

    python3 port_bench/run.py --workload grid3d.certify --seed 7 \
        --seconds 30 --trace 0

Generates the seed's input, sets the port up (kernel builds and one
warm-up solve count as set-up), solves back to back for --seconds, then
judges the window's answers against the plain reference.  With --trace 0
the line holds the cell's end-to-end metrics, with --trace 1 its
per-layer metrics read from a torch.profiler trace.  The numbers compared
are printed last on standard error and under "checks", last in the line.
Refuses to run without a CUDA device.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
THREADS = "4"


def environment():
    """Fixed cache directories inside the checkout, the port's default
    policy (no DCORA_* switch) and a few host threads."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    for var in [v for v in os.environ if v.startswith("DCORA_")]:
        del os.environ[var]
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = THREADS


def card_limit() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    sys.path.insert(0, ROOT)
    import torch

    from port_bench import harness

    cell = harness.find_cell(args.workload, ROOT)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(int(THREADS))
    tmp = tempfile.mkdtemp(prefix="port_bench_")
    try:
        out = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", tmp, T_PROCESS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out.pop("readings")
    out["card"] = card_limit()
    checks = out.pop("checks")
    out["checks"] = checks
    print(f"card: {out['card']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
