"""The PyTorch port's edge path timed in two checkouts, in turns.

    python tools/torch_edge_ab.py OTHER_TREE [--out FILE]

OTHER_TREE is another checkout of the repository (the parent commit, say,
unpacked with ``git archive`` into ``checkouts/``, which ``.gitignore``
lists).  The script runs four turns, other, this, this, other, each in a
process of its own that imports the ``dcora_tpu_torch`` of its tree; the
set-up and timing helpers come from this checkout's
``dcora_tpu_torch/tools/common.py`` (loaded by path), so both trees are
driven by the same code.  Per turn, on the card:

  * ``tcg``: ms per iteration of the edge path's 200-iteration tCG solve
    through its CUDA graph (``common.edge_tcg``) at rank 3 from the
    odometry init, on ra10k and on ra500 (CUDA events, median of 3 turns);
  * ``apply_Q``: ms per eager ``problem.apply_Q`` at ra10k, rank 3 (events,
    100 back to back, median of 3 turns; host issue included);
  * ``chordal``: seconds of grid10k's chordal init on the card (two eager
    CG solves, a segment sum per iteration) and the CG iterations of each;
  * ``dc2pgo``: ms per round of DC2-PGO's eager RBCD (5 robots on the
    generated smallGrid3D of the smoke run, Chordal init, RBCD only,
    ``--rounds`` rounds).

Prints one JSON object per turn and writes them all to ``--out`` (default
``chiprun_out/torch_edge_ab.json``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ("other", "this", "this", "other")
# smallGrid3D as the smoke run's DC2-PGO cell generates it
# (tests/data/torch_port_robust_reference.json: mr_smallGrid3D)
SMALL_GRID = dict(shape=(5, 5, 5), rot_noise=0.05, trans_noise=0.02,
                  seed=12)


def _common():
    spec = importlib.util.spec_from_file_location(
        "edge_ab_common",
        os.path.join(HERE, "dcora_tpu_torch", "tools", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn(rounds: int) -> dict:
    """One turn in the tree whose root is first on sys.path."""
    import torch

    import dcora_tpu_torch
    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.core import problem as prob
    from dcora_tpu_torch.core import spmm
    from dcora_tpu_torch.core.init import chordal_initialization
    from dcora_tpu_torch.drivers import multi_robot_pgo
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.types import InitializationMethod

    common = _common()
    common.require_cuda("torch_edge_ab")
    spmm.build_all()
    rec = dict(package=os.path.dirname(dcora_tpu_torch.__file__),
               platform=common.platform("cuda"), tcg={})
    spmm.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        for name, per_robot in (("ra10k", 1950), ("ra500", 100)):
            t = common.edge_tcg(common.ra_set(tmp, per_robot), 3, 200)
            iters = int(t.solve().inner_iters)
            ms = common.time_turns_ms([t.solve], n=1)[0]
            rec["tcg"][name] = dict(iterations=iters,
                                    ms_per_iteration=ms / iters)
            if name == "ra10k":
                rec["apply_Q_ms"] = common.time_turns_ms(
                    [lambda: prob.apply_Q(t.P, t.X)])[0]
        meas = read_g2o_file(common.default_grid(tmp)).pose_pose_measurements
        chordal_initialization(meas, device="cuda")  # warm-up
        torch.cuda.synchronize()
        iters = []
        t0 = time.perf_counter()
        chordal_initialization(meas, device="cuda", cg_iters=iters)
        torch.cuda.synchronize()
        rec["chordal_s"] = time.perf_counter() - t0
        rec["chordal_cg_iterations"] = iters
        path = datasets.generate_grid_g2o(os.path.join(tmp, "small.g2o"),
                                          **SMALL_GRID)
        res = multi_robot_pgo.run(5, path, num_iters=rounds,
                                  init_method=InitializationMethod.Chordal,
                                  rbcd_only=True, device="cuda")
        torch.cuda.synchronize()
        n = len(res.cost_trace)
        rec["dc2pgo"] = dict(rounds=n, rbcd_s=res.rbcd_s,
                             ms_per_round=1e3 * res.rbcd_s / max(n, 1))
    rec["launches"] = spmm.launch_counts()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "torch_edge_ab.json"))
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.turn:  # a child: the tree to import is a.turn
        sys.path.insert(0, a.turn)
        rec = turn(a.rounds)
        if not rec["package"].startswith(os.path.abspath(a.turn)):
            raise SystemExit(f"imported {rec['package']}, not {a.turn}'s")
        with open(a.out, "w") as fh:
            json.dump(rec, fh)
        return 0
    if not a.other:
        ap.error("OTHER_TREE is required")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    trees = {"other": os.path.abspath(a.other), "this": HERE}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    records = []
    for i, side in enumerate(TURNS, 1):
        js = os.path.abspath(f"{a.out}.{i}_{side}.json")
        rc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn",
             trees[side], "--out", js, "--rounds", str(a.rounds)],
            cwd=trees[side], env=env).returncode
        rec = dict(turn=i, side=side, tree=trees[side], rc=rc)
        if rc == 0:
            with open(js) as fh:
                rec.update(json.load(fh))
        records.append(rec)
        print(json.dumps(rec), flush=True)
    with open(a.out, "w") as fh:
        json.dump(records, fh, indent=1)
    return 0 if all(r["rc"] == 0 for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
