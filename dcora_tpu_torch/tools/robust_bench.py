"""Robust GNC benchmark of the port: outlier classification on a generated
pose graph.

Counterpart of ``tools/robust_bench.py``.  Plants gross outlier loop
closures into a generated grid with ``datasets.corrupt_with_outliers``
(the testRobust.cpp:228-309 pattern at benchmark scale), then runs

  1. the centralized GNC (``drivers.single_robot_gnc.run``, solveRobustPGO
     at the driver's parameters; every stage a solve_pgo through the SpMM
     kernel at 500 poses or more), and
  2. the distributed GNC (``drivers.multi_robot_pgo.run`` with GNC-TLS, at
     the JAX tool's parameters and a cap of ``--rounds`` RBCD rounds per
     rank),

and reports the weight classification's precision and recall, the final
cost on the clean problem (unit weights, planted edges left out) and the
independent verifier's verdict on it.  Its default set is a generated
10x10x25 grid of 2,500 poses, the size of sphere2500 (absent here),
corrupted as artifacts/robust_sphere2500.json was (15 %, seed 7).

    python -m dcora_tpu_torch.tools.robust_bench [--device cuda]
        [--frac 0.15] [--seed 7] [--robots 5] [--rounds 800]
        [--skip-distributed] [--out robust_bench.json]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

# the generated stand-in for sphere2500 (tests/make_torch_port_reference.py
# records the JAX package's results on the same set)
GNC_GRID = dict(shape=(10, 10, 25), rot_noise=0.05, trans_noise=0.02,
                seed=42)
GNC_CORRUPT = dict(frac=0.15, seed=7)
# the distributed GNC at the JAX tool's parameters (tools/robust_bench.py)
DIST_KW = dict(r_min=5, r_max=10, robust_inner_iters=150,
               robust_weight_updates=25)
DIST_ROBUST = dict(GNCBarc=5.0, GNCMaxNumIters=60)


def gnc_set(directory: str) -> str:
    """Generate the 2,500-pose grid into `directory`; returns its path."""
    from dcora_tpu_torch import datasets

    return datasets.generate_grid_g2o(os.path.join(directory,
                                                   "gnc2500.g2o"),
                                      **GNC_GRID)


def classification(weights: dict, outlier_keys, w_tol: float = 0.5):
    """Precision and recall of the GNC classification: an edge is rejected
    iff its final weight < w_tol (weights: {(p1, p2): w})."""
    tp = fp = fn = tn = 0
    for key, w in weights.items():
        rejected = w < w_tol
        if key in outlier_keys:
            tp += rejected
            fn += not rejected
        else:
            fp += rejected
            tn += not rejected
    return dict(tp=int(tp), fp=int(fp), fn=int(fn), tn=int(tn),
                precision=float(tp / max(tp + fp, 1)),
                recall=float(tp / max(tp + fn, 1)))


def clean_report(clean, T: np.ndarray, d: int, eta: float = 1e-3) -> dict:
    """The independent verifier on the clean problem (unit weights) at the
    rank-d trajectory T."""
    from dcora_tpu_torch.core import lifted
    from dcora_tpu_torch.verification import verify_solution

    saved = [m.weight for m in clean]
    for m in clean:
        m.weight = 1.0
    try:
        rep = verify_solution(clean, lifted.from_pose_array(T), d, eta=eta)
    finally:
        for m, w in zip(clean, saved):
            m.weight = w
    return dict(f_on_clean=float(rep["f_indep"]),
                gradnorm_on_clean=float(rep["gradnorm_indep"]),
                certified_on_clean=bool(rep["certified_indep"]))


def central(path: str, device="cuda", frac: float = 0.15, seed: int = 7,
            verbose: bool = False):
    """The centralized GNC on the corrupted set.  Returns (record, the
    corrupted measurements at their final weights): rejected edges (weight
    < 1e-8), the final weights, the weighted problem's cost and gradient
    norm at the result (the independent verifier), classification,
    per-stage seconds and the clean report."""
    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.core import lifted
    from dcora_tpu_torch.drivers import single_robot_gnc
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.verification import verify_solution

    ds = read_g2o_file(path)
    clean = ds.pose_pose_measurements
    corrupted, outliers = datasets.corrupt_with_outliers(clean, frac=frac,
                                                         seed=seed)
    stats = []
    t0 = time.perf_counter()
    T, ms = single_robot_gnc.run(path, verbose=verbose, device=device,
                                 measurements=corrupted, stats=stats)
    wall = time.perf_counter() - t0
    weights = {(m.p1, m.p2): m.weight for m in ms if not m.fixedWeight}
    weighted = verify_solution(ms, lifted.from_pose_array(T), ds.dim,
                               eta=1e-3)
    rec = dict(n=ds.num_poses, edges=len(clean), outliers=len(outliers),
               rejected=sorted([list(k) for k, w in weights.items()
                                if w < 1e-8]),
               weights={f"{k[0]},{k[1]}": w
                        for k, w in sorted(weights.items())},
               f_weighted=float(weighted["f_indep"]),
               gradnorm_weighted=float(weighted["gradnorm_indep"]),
               classification=classification(weights, outliers),
               wall_s=wall, stages=len(stats),
               init_s=sum(s.get("init_s", 0.0) for s in stats),
               build_s=sum(s.get("build_s", 0.0) for s in stats),
               total_s=sum(s.get("total_s", 0.0) for s in stats))
    rec["solve_s"] = rec["total_s"] - rec["init_s"] - rec["build_s"]
    rec.update(clean_report(clean, T, ds.dim))
    return rec, ms


def distributed(path: str, directory: str, rounds: int, device="cuda",
                robots: int = 5, frac: float = 0.15, seed: int = 7,
                lifting_matrix=None, r_max: int = DIST_KW["r_max"],
                robust_inner_iters: int = DIST_KW["robust_inner_iters"]
                ) -> dict:
    """The distributed GNC (multi_robot_pgo.run, GNC-TLS, Chordal init) on
    the corrupted set written to `directory`, `rounds` RBCD rounds per rank
    at most, up to rank `r_max`, a weight update after
    `robust_inner_iters` inner iterations (at most five times as many
    rounds): the cost per round, rank, rounds, weights, classification and
    ms per round."""
    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.drivers.multi_robot_pgo import run
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.types import (InitializationMethod,
                                       RobustCostParameters, RobustCostType)

    ds = read_g2o_file(path)
    corrupted, outliers = datasets.corrupt_with_outliers(
        ds.pose_pose_measurements, frac=frac, seed=seed)
    cpath = datasets.write_g2o(os.path.join(directory, "corrupted.g2o"),
                               corrupted, ds.dim)
    t0 = time.perf_counter()
    res = run(robots, cpath, num_iters=rounds,
              init_method=InitializationMethod.Chordal,
              robust_cost_params=RobustCostParameters(
                  costType=RobustCostType.GNC_TLS, **DIST_ROBUST),
              device=device, lifting_matrix=lifting_matrix,
              **dict(DIST_KW, r_max=r_max,
                     robust_inner_iters=robust_inner_iters))
    wall = time.perf_counter() - t0
    rounds = len(res.cost_trace)
    return dict(certified=bool(res.certified), final_rank=res.final_rank,
                total_iters=res.total_iters, rounds=rounds,
                final_cost=res.cost_trace[-1] if res.cost_trace else None,
                cost_trace=res.cost_trace,
                weights={f"{k[0]},{k[1]}": w
                         for k, w in sorted(res.weights.items())},
                classification=classification(res.weights, outliers),
                ms_per_round=1e3 * res.rbcd_s / max(rounds, 1),
                wall_s=wall)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("g2o", nargs="?", default=None,
                    help="pose graph (default: the generated 2,500-pose "
                    "grid)")
    ap.add_argument("--frac", type=float, default=GNC_CORRUPT["frac"])
    ap.add_argument("--seed", type=int, default=GNC_CORRUPT["seed"])
    ap.add_argument("--robots", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=800,
                    help="RBCD rounds per rank of the distributed GNC")
    ap.add_argument("--r-max", type=int, default=DIST_KW["r_max"])
    ap.add_argument("--skip-distributed", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from dcora_tpu_torch.tools.common import card, require_cuda

        require_cuda("robust_bench")
        print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.g2o or gnc_set(tmp)
        rec = dict(central=central(path, dev, args.frac, args.seed)[0])
        print(json.dumps({k: v for k, v in rec["central"].items()
                          if k not in ("rejected", "weights")}), flush=True)
        if not args.skip_distributed:
            rec["distributed"] = distributed(path, tmp, args.rounds, dev,
                                             args.robots, args.frac,
                                             args.seed, r_max=args.r_max)
            print(json.dumps({k: v for k, v in rec["distributed"].items()
                              if k not in ("weights", "cost_trace")}),
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
    return rec


if __name__ == "__main__":
    main()
