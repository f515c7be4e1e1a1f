"""Parallel-RBCD sweep over the number of agents on one card.

Counterpart of ``tools/scaling_bench.py``.  The same graph (default: the
generated 10,648-pose grid) is split into A agents for each A of the sweep
and ``rounds`` synchronous-parallel rounds are timed after ``warmup``
rounds (odometry init, as the JAX tool).  All agents share one card, so
the JAX tool's strong-scaling efficiency (one device per agent) does not
apply: the output marks ``"devices": 1``, and beside the times it gives
the strip kernel's launches per round: one launch per batched tile
product serves every agent, so they count the tCG iterations of a
round's slowest agent, not the agents.  The tiled path runs at float32
tiles, the drivers' default on the card.

    python -m dcora_tpu_torch.tools.scaling_bench [file.g2o]
        [--agents 1 2 4 8 16] [--rounds 20] [--backend tiled|edge]
        [--out chiprun_out/scaling_grid10k.json]

Prints one line per A and writes the sweep as JSON.  Refuses to run
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch


def measure(path: str, num_agents: int, rounds: int, r: int = 5,
            backend: str = "tiled", warmup: int = 3, device="cuda") -> dict:
    """rounds/s, pose-updates/s and strip-kernel launches per round of A
    agents on `path`, with the host seconds of the build."""
    from dcora_tpu_torch.core import lifted, spmm
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.core.init import odometry_initialization
    from dcora_tpu_torch.core.lifted import RAState
    from dcora_tpu_torch.drivers.multi_robot_pgo import (
        partition_measurements,
        robot_slice,
    )
    from dcora_tpu_torch.drivers.parallel_pgo import ROUND_CFG
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.parallel.rbcd import (
        ParallelRound,
        build_parallel_problem,
        pack_states,
    )

    ds = read_g2o_file(path)
    ms = ds.pose_pose_measurements
    d, n = ds.dim, ds.num_poses
    odo, priv, shared, _ = partition_measurements(ms, n, num_agents)
    graphs = []
    for a in range(num_agents):
        g = LocalGraph(a, r, d)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)
    t0 = time.perf_counter()
    pp = build_parallel_problem(graphs)
    rnd = ParallelRound(pp, ROUND_CFG, backend=backend,
                        tile_dtype=torch.float32, device=device)
    build_s = time.perf_counter() - t0
    T = odometry_initialization([m for m in ms if m.p1 + 1 == m.p2])
    X = lifted.pad_rank(lifted.from_pose_array(T, device=device), r)
    Xb = pack_states(pp, [
        RAState(rot=X.rot[s:e], sph=X.sph[:0], trn=X.trn[s:e])
        for s, e in (robot_slice(n, num_agents, a)
                     for a in range(num_agents))], device)
    for _ in range(warmup):
        Xb, _ = rnd(Xb)
    torch.cuda.synchronize()
    spmm.reset_launches()
    t0 = time.perf_counter()
    for _ in range(rounds):
        Xb, _ = rnd(Xb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spmm.launch_counts()
    real, padded = pp.scalar_columns()
    return dict(agents=num_agents, devices=1, backend=backend, rounds=rounds,
                rounds_per_s=rounds / wall,
                pose_updates_per_s=rounds * n / wall,
                ms_per_round=1e3 * wall / rounds,
                spmm_sym_per_round=launches["spmm_sym"] / rounds,
                other_kernel_launches=launches["spmm_symmetric"]
                + launches["spmm_paired"],
                padding_share=1.0 - real / padded, build_s=build_s)


def main():
    from dcora_tpu_torch.tools import common

    ap = argparse.ArgumentParser()
    ap.add_argument("g2o", nargs="?", default=None,
                    help="default: the generated 10,648-pose grid")
    ap.add_argument("--agents", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--rank", type=int, default=5)
    ap.add_argument("--backend", default="tiled", choices=["tiled", "edge"])
    ap.add_argument("--out", default=None,
                    help="JSON output (default chiprun_out/scaling_<name>"
                    ".json)")
    args = ap.parse_args()
    common.require_cuda("scaling_bench")
    with tempfile.TemporaryDirectory() as tmp:
        path = args.g2o or common.default_grid(tmp)
        name = os.path.splitext(os.path.basename(path))[0]
        sweep = []
        for A in args.agents:
            rec = measure(path, A, args.rounds, r=args.rank,
                          backend=args.backend)
            sweep.append(rec)
            print(f"[scaling] {name} A={A}: {rec['ms_per_round']:.3f} ms "
                  f"per round, {rec['rounds_per_s']:.2f} rounds/s, "
                  f"{rec['pose_updates_per_s']:.0f} pose-updates/s, "
                  f"spmm_sym {rec['spmm_sym_per_round']:.1f} per round, "
                  f"padding {100 * rec['padding_share']:.2f} %, build "
                  f"{rec['build_s']:.2f}s", flush=True)
    out = args.out or os.path.join("chiprun_out", f"scaling_{name}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as fh:
        json.dump(dict(dataset=name, card=common.card(), devices=1,
                       sweep=sweep), fh, indent=1)
    print(f"[scaling] wrote {out}")


if __name__ == "__main__":
    main()
