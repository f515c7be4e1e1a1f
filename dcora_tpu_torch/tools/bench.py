"""Benchmark: lifted PGO RTR throughput on one CUDA device.

    python -m dcora_tpu_torch.tools.bench [--pack bucketed|paired]

Counterpart of ``bench.py``.  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "poses*iters/s", "vs_baseline": N}

metric: poses*iterations/s of the full Riemannian trust-region step on the
flat f32 tiled backend (20 outer iterations, each up to 50 preconditioned
tCG inner iterations) at rank 5, on DCORA_BENCH_DATASET or, by default, the
generated 10,648-pose grid (``generate_large_scale_g2o(target_poses=
10_000)``; bench.py's city10000.g2o is not in the repository).  ``--pack``
selects the SpMM layout: ``bucketed`` runs the owner-computes CSR kernel,
``paired`` the two-row K-fused grouped kernel.

vs_baseline: ratio against the same CPU scipy stand-in for the reference's
Eigen/CHOLMOD per-iteration work as bench.py (sparse Q SpMV x tCG iters +
factorized block-Jacobi solves), measured once per dataset and cached in
``dcora_tpu_torch/build/bench_baseline.json``.  Refuses to run without
CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from dcora_tpu_torch.core import lifted, spmm, tiled
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import odometry_initialization
from dcora_tpu_torch.core.rtr import FLAT_BACKEND, RTRConfig, rtr
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.tools import common

RANK = 5
OUTER_ITERS = 20
TCG_ITERS = 50
BASELINE_CACHE = os.path.join(spmm.BUILD_DIR, "bench_baseline.json")


def measure_cpu_baseline(ds, n, d):
    """Reference-equivalent CPU cost of one RTR outer iteration:
    TCG_ITERS x (sparse SpMV + preconditioner solve) at rank RANK
    (bench.py's measure_cpu_baseline)."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    dh = d + 1
    ms = ds.pose_pose_measurements
    rows, cols, vals = [], [], []

    def add_block(bi, bj, B):
        for r_ in range(B.shape[0]):
            for c_ in range(B.shape[1]):
                v = B[r_, c_]
                if v != 0:
                    rows.append(bi + r_)
                    cols.append(bj + c_)
                    vals.append(v)

    for m in ms:
        i, j = m.p1, m.p2
        kap, tau = m.kappa, m.tau
        T = np.zeros((dh, dh))
        T[:d, :d] = m.R
        T[:d, d] = m.t
        T[d, d] = 1.0
        Om = np.diag([kap] * d + [tau])
        add_block(i * dh, i * dh, T @ Om @ T.T)
        add_block(j * dh, j * dh, Om)
        add_block(i * dh, j * dh, -T @ Om)
        add_block(j * dh, i * dh, -(T @ Om).T)
    Q = sp.csr_matrix(
        (vals, (rows, cols)), shape=(dh * n, dh * n)
    )
    # block-diagonal preconditioner factorization (one-time, excluded)
    D = sp.block_diag(
        [np.asarray(Q[i * dh:(i + 1) * dh, i * dh:(i + 1) * dh].todense())
         + 0.1 * np.eye(dh) for i in range(n)]
    ).tocsc()
    solve = spla.factorized(D)

    rng = np.random.default_rng(0)
    V = rng.standard_normal((dh * n, RANK))
    # warm up
    _ = Q @ V
    _ = solve(V)
    t0 = time.time()
    reps = 3
    for _ in range(reps):
        W = V
        for _ in range(TCG_ITERS):
            W = Q @ W
            W = solve(W)
        float(W[0, 0])
    per_outer = (time.time() - t0) / reps
    return per_outer


def cpu_baseline(ds, path: str) -> float:
    """Seconds per outer iteration of the CPU baseline, cached by
    dataset."""
    key = f"{os.path.basename(path)}:r{RANK}:tcg{TCG_ITERS}"
    cache = {}
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as fh:
            cache = json.load(fh)
    if key not in cache:
        cache[key] = measure_cpu_baseline(ds, ds.num_poses, ds.dim)
        os.makedirs(os.path.dirname(BASELINE_CACHE), exist_ok=True)
        with open(BASELINE_CACHE, "w") as fh:
            json.dump(cache, fh)
    return cache[key]


def run(path: str, pack: str = "bucketed") -> dict:
    """The timed flat f32 RTR run on `path`; returns bench.py's JSON
    object."""
    common.require_cuda("bench")
    ds = read_g2o_file(path)
    n, d = ds.num_poses, ds.dim
    g = LocalGraph(0, RANK, d)
    g.set_measurements(ds.pose_pose_measurements)
    TP = tiled.build_tiled(g.problem_data(device="cuda"), g.dims,
                           dtype=torch.float32, pack=pack)
    cfg = RTRConfig(gradnorm_tol=1e-300, max_outer=OUTER_ITERS,
                    max_inner=TCG_ITERS)
    T = odometry_initialization(
        [m for m in ds.pose_pose_measurements if m.p1 + 1 == m.p2])
    X0 = lifted.pad_rank(lifted.from_pose_array(T, device="cuda"), RANK)
    Xf0 = tiled.to_flat(TP, X0, r_pad=8).float()

    rtr(TP, None, None, Xf0, cfg, be=FLAT_BACKEND)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rtr(TP, None, None, Xf0, cfg, be=FLAT_BACKEND)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    iters = res.outer_iters
    gpu_per_outer = elapsed / max(iters, 1)
    return {
        "metric": (
            f"lifted-PGO RTR poses*iters/s on {os.path.basename(path)} "
            f"(rank {RANK}, {TCG_ITERS} tCG/iter; flat f32 tiles, {pack} "
            f"pack, {torch.cuda.get_device_name(0)})"
        ),
        "value": round(n * iters / elapsed, 1),
        "unit": "poses*iters/s",
        "vs_baseline": round(cpu_baseline(ds, path) / gpu_per_outer, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pack", choices=("bucketed", "paired"),
                    default="bucketed")
    args = ap.parse_args(argv)
    common.require_cuda("bench")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.environ.get("DCORA_BENCH_DATASET") or \
            common.default_grid(tmp)
        out = run(path, pack=args.pack)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
