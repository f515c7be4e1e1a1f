"""Repeatability of the RA staircase.

    python -m dcora_tpu_torch.tools.ra_repeat [--sets ra500 ra10k]
        [--runs 3] [--device cuda] [--out FILE]

It runs ``drivers.single_robot_raslam.run`` on the generated RA sets
(``tools.common.ra_set``: ra500 climbs to r_max 20, ra10k runs its first
rank, r_max 3) ``--runs`` times each in one process.  Per run it
records the certified rank, f* (its repr), the min-eigenvalue history, the
gradient norm, the wall time, a SHA-256 of the final iterate's bytes and,
per RTR call (``profile_slice.CallLog``: phase, rank, outer iterations,
tCG steps, cost and gradient norm at its end), the trace of the solve;
then whether the runs agree bit for bit, and f*'s distance from the JAX
package's (``tests/data/torch_port_ra_reference.json``) against the smoke
run's 1e-6.  With ``--device cpu`` it records the CPU's trace, to hold the
card's against.  The exit code is 1 when the runs differ or f* misses the
reference by more than 1e-6.

Prints one JSON object per set and writes them all to ``--out`` (default
under ``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import torch

from dcora_tpu_torch.tools import common

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# name -> (poses per robot, r_max), as chip_smoke.py's RA_SETS
SETS = {"ra500": (100, 20), "ra10k": (1950, 3)}
RA_F_RTOL = 1e-6


def _digest(X) -> str:
    h = hashlib.sha256()
    for x in X:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def staircase_runs(path: str, r_max: int, runs: int, device: str) -> list:
    """`runs` RA staircases of one set; one record each."""
    from dcora_tpu_torch.drivers.single_robot_raslam import run
    from dcora_tpu_torch.tools.profile_slice import CallLog

    out = []
    for i in range(runs):
        res = {}
        with CallLog(profile=False) as log:
            t0 = time.perf_counter()
            st, _, _ = run(path, r_max=r_max, device=device, verbose=False,
                           result=res)
            if device != "cpu":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out.append(dict(
            run=i, rank=st.final_rank, certified=bool(st.certified),
            f_star=repr(res["f_rounded"]), f_lifted=repr(st.f_final),
            gradnorm=float(st.gradnorm_final),
            min_eig_history=[float(x) for x in st.min_eig_history],
            x_sha256=_digest(st.X), wall_s=wall,
            stages_s=dict(st.stage_seconds), trace=log.calls))
    return out


def staircase(sets, runs: int, device: str) -> list:
    from dcora_tpu_torch.core import spmm

    if device != "cpu":
        common.require_cuda("ra_repeat")
        spmm.build_all()
    ref_path = os.path.join(HERE, "tests", "data",
                            "torch_port_ra_reference.json")
    refs = {}
    if os.path.exists(ref_path):
        with open(ref_path) as fh:
            refs = json.load(fh)
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in sets:
            per_robot, r_max = SETS[name]
            recs = staircase_runs(common.ra_set(tmp, per_robot), r_max,
                                  runs, device)
            keys = ("rank", "f_star", "min_eig_history", "x_sha256")
            same = {k: len({json.dumps(r[k]) for r in recs}) == 1
                    for k in keys}
            rec = dict(set=name, device=device,
                       platform=common.platform(device), r_max=r_max,
                       runs=recs, same=same, repeats=all(same.values()))
            ref = refs.get(name)
            if ref is not None and ref.get("certified"):
                rels = [abs(float(r["f_star"]) - ref["f"]) / abs(ref["f"])
                        for r in recs]
                rec.update(jax_f=ref["f"], jax_rank=ref["rank"],
                           f_rel_to_jax=rels,
                           within_gate=max(rels) <= RA_F_RTOL)
            records.append(rec)
            print(json.dumps({k: v for k, v in rec.items() if k != "runs"}
                             | dict(runs=[{k: v for k, v in r.items()
                                           if k != "trace"}
                                          for r in recs])), flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sets", nargs="+", default=list(SETS),
                    choices=list(SETS))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    out = a.out or os.path.join(HERE, "chiprun_out",
                                f"ra_repeat_{a.device}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    records = staircase(a.sets, a.runs, a.device)
    with open(out, "w") as fh:
        json.dump(records, fh, indent=1)
    ok = all(r["repeats"] and r.get("within_gate", True) for r in records)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
