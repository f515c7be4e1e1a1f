"""Parity harness: run the reference's flagship configs end to end on the
card and record independently verified results as committed artifacts.

Counterpart of the JAX package's ``tools/parity.py``, over the port's
drivers.  Parity is established through the certifiable-optimization
protocol: a solution that passes the scipy-assembled dual-certificate check
(verification.verify_solution, which shares no code with the engine) is
the global optimum of the same SDP relaxation the reference certifies
against (DCORA_utils.cpp:1898-1982).  For every config this records the
engine's final cost and verdict, the independent scipy cost under the
incidence-matrix Q, the independent Riemannian gradient norm, the
independent certificate min-eig and LDL^T witness, the rounded solution's
cost, and ATE vs the dataset's ground truth where the file embeds one.

The port keeps its records apart from the JAX package's: one JSON per
config under artifacts/torch/parity/, the final states under
artifacts/torch/parity/state/ (gitignored), and ``--summary`` writes the
table to artifacts/torch/PARITY.md.  ``"platform"`` is the card's name and
power limit (nvidia-smi), or "cpu".

Datasets come from ``--data-dir`` (default: $DCORA_DATA_DIR, else the
generated test sets of ``datasets.ensure_test_datasets`` in
dcora_tpu_torch/build/data: tinyGrid3D, smallGrid3D and
range_aided_slam_test_3d.pyfg, which serve tinyGrid3D, smallGrid3D,
ra_slam_test_3d, multi_robot_smallGrid3D and multi_robot_ra_test_3d).  A
config whose file is absent raises FileNotFoundError naming the file.

Usage:
  python -m dcora_tpu_torch.tools.parity --configs tinyGrid3D smallGrid3D
      [--device cuda|cpu] [--data-dir DIR]
  python -m dcora_tpu_torch.tools.parity --reverify --configs tinyGrid3D
  python -m dcora_tpu_torch.tools.parity --summary
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import time
from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ART = os.path.join(REPO, "artifacts", "torch", "parity")
STATE_DIR = os.path.join(ART, "state")  # gitignored npz of the final X
SUMMARY = os.path.join(REPO, "artifacts", "torch", "PARITY.md")
GENERATED_DATA = os.path.join(REPO, "dcora_tpu_torch", "build", "data")

# reference driver configs being mirrored:
#   PGO: MultiRobotExample.cpp / SingleRobotExample.cpp (r_min=5, eta 1e-3)
#   RA:  SingleRobotExample_RASLAM.cpp (r_min=d, r_max=20, eta 1e-4)
CONFIGS = {
    "tinyGrid3D": dict(kind="pgo", file="tinyGrid3D.g2o", r_min=5,
                       r_max=10, eta=1e-3),
    "smallGrid3D": dict(kind="pgo", file="smallGrid3D.g2o", r_min=5,
                        r_max=10, eta=1e-3),
    "parking-garage": dict(kind="pgo", file="parking-garage.g2o", r_min=5,
                           r_max=12, eta=1e-3),
    "sphere2500": dict(kind="pgo", file="sphere2500.g2o", r_min=5,
                       r_max=12, eta=1e-3),
    "torus3D": dict(kind="pgo", file="torus3D.g2o", r_min=5, r_max=12,
                    eta=1e-3),
    "city10000": dict(kind="pgo", file="city10000.g2o", r_min=5, r_max=12,
                      eta=1e-3),
    # 2D PGO benchmarks (EDGE_SE2; same staircase, d=2)
    "CSAIL": dict(kind="pgo", file="CSAIL.g2o", r_min=5, r_max=12,
                  eta=1e-3),
    "kitti_00": dict(kind="pgo", file="kitti_00.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    "kitti_02": dict(kind="pgo", file="kitti_02.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    "kitti_05": dict(kind="pgo", file="kitti_05.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    "kitti_06": dict(kind="pgo", file="kitti_06.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    # rtr_iters raised: the 200-outer budget stalled at gradnorm 3.9e-3
    # against eta=1e-3, leaving cert_slack above the claimed tolerance
    "kitti_07": dict(kind="pgo", file="kitti_07.g2o", r_min=5, r_max=12,
                     eta=1e-3, rtr_iters=600),
    "kitti_08": dict(kind="pgo", file="kitti_08.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    "kitti_09": dict(kind="pgo", file="kitti_09.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    "input_INTEL": dict(kind="pgo", file="input_INTEL_g2o.g2o", r_min=5,
                        r_max=12, eta=1e-3),
    # rtr_iters raised (see kitti_07): recorded indep gradnorm 1.19e-3
    # sits above eta, leaving the certificate on O(gradnorm) slack
    "input_M3500": dict(kind="pgo", file="input_M3500_g2o.g2o", r_min=5,
                        r_max=12, eta=1e-3, rtr_iters=600),
    "input_MITb": dict(kind="pgo", file="input_MITb_g2o.g2o", r_min=5,
                       r_max=12, eta=1e-3),
    # rtr_iters raised (see kitti_07): round-4 certified at gradnorm
    # 6.1e-3 > eta; the deeper budget drives cert_slack below tolerance
    "ais2klinik": dict(kind="pgo", file="ais2klinik.g2o", r_min=5,
                       r_max=12, eta=1e-3, rtr_iters=600),
    # 3D PGO benchmarks
    "sphere_bignoise": dict(kind="pgo", file="sphere_bignoise_vertex3.g2o",
                            r_min=5, r_max=12, eta=1e-3),
    "cubicle": dict(kind="pgo", file="cubicle.g2o", r_min=5, r_max=12,
                    eta=1e-3),
    # PyFG SE-only test data through the RA driver (l=0 degenerate case)
    "pyfg_se2_test": dict(kind="ra", file="pyfg_se2_test_data.pyfg",
                          r_max=20, eta=1e-4),
    "pyfg_se3_test": dict(kind="ra", file="pyfg_se3_test_data.pyfg",
                          r_max=20, eta=1e-4),
    "ra_slam_test_3d": dict(kind="ra", file="range_aided_slam_test_3d.pyfg",
                            r_max=20, eta=1e-4),
    "ra_slam_test_2d": dict(kind="ra", file="range_aided_slam_test_2d.pyfg",
                            r_max=20, eta=1e-4),
    "single_drone": dict(kind="ra", file="single_drone.pyfg", r_max=20,
                         eta=1e-4),
    "tiers": dict(kind="ra", file="tiers.pyfg", r_max=20, eta=1e-4),
    # num_iters raised from the demo's 1000: the sequential greedy RBCD
    # needs ~5k iterations to pass the PSD gradient-noise gate (10*eta)
    # once the adaptive stop tightens below the demo tol 0.1
    "multi_robot_smallGrid3D": dict(kind="dc2pgo", file="smallGrid3D.g2o",
                                    robots=5, r_min=5, r_max=10, eta=1e-3,
                                    num_iters=4000),
    # multi-robot DCORA (2 robots A/B in the file) — the distributed RA
    # path of MultiRobotExample_RASLAM.cpp.  Uses the demo stop tol 0.1
    # (MultiRobotExample_RASLAM.cpp:101): the adaptive RBCD->certificate
    # stop tightens it automatically when the dual certificate is
    # inconclusive within the O(gradnorm) slack.
    "multi_robot_ra_test_3d": dict(kind="dcora",
                                   file="range_aided_slam_test_3d.pyfg",
                                   r_max=10, eta=1e-3, tol=0.1),
}


def default_data_dir() -> str:
    """$DCORA_DATA_DIR, else the generated test sets (made on first use)."""
    env = os.environ.get("DCORA_DATA_DIR")
    if env:
        return env
    from dcora_tpu_torch.datasets import ensure_test_datasets

    return ensure_test_datasets(GENERATED_DATA)


def _trajectory(X, n: int) -> np.ndarray:
    """[n, d, d+1] poses of a rank-d state."""
    return np.concatenate([X.rot.cpu().numpy(),
                           X.trn[:n].cpu().numpy()[:, :, None]], axis=2)


def _ground_truth(ds) -> Optional[np.ndarray]:
    if not ds.ground_truth_poses:
        return None
    return np.stack([np.asarray(ds.ground_truth_poses[k])
                     for k in sorted(ds.ground_truth_poses)])


def _result(res, elapsed: float) -> dict:
    """The engine's fields of a StaircaseResult."""
    return dict(certified=bool(res.certified),
                final_rank=int(res.final_rank), f_final=float(res.f_final),
                elapsed_s=elapsed, gradnorm_final=float(res.gradnorm_final),
                cert_slack=float(res.cert_slack))


def _rbcd_result(res, elapsed: float) -> dict:
    """The engine's fields of a multi-robot result."""
    return dict(certified=bool(res.certified),
                final_rank=int(res.final_rank),
                f_final=(res.cost_trace[-1] if res.cost_trace else None),
                total_iters=int(res.total_iters), elapsed_s=elapsed,
                gradnorm_final=(res.gradnorm_trace[-1]
                                if res.gradnorm_trace else None),
                final_theta=res.final_theta, cert_slack=res.cert_slack)


def run_pgo(path, cfg, device="cuda", checkpoint_path=None):
    from dcora_tpu_torch.core import lifted, problem as prob
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.core.init import chordal_initialization
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.staircase import riemannian_staircase
    from dcora_tpu_torch.types import ROptParameters

    ds = read_g2o_file(path)
    d = ds.dim
    g = LocalGraph(0, cfg["r_min"], d)
    g.set_measurements(ds.pose_pose_measurements)
    T0 = chordal_initialization(ds.pose_pose_measurements, device=device)
    X0 = lifted.pad_rank(lifted.from_pose_array(T0, device=device),
                         cfg["r_min"])
    t0 = time.time()
    res = riemannian_staircase(
        g, X0, r_min=cfg["r_min"], r_max=cfg["r_max"],
        opt_params=ROptParameters(
            gradnorm_tol=cfg.get("gradnorm_tol", 1e-4),
            RTR_iterations=cfg.get("rtr_iters", 200),
            RTR_tCG_iterations=cfg.get("tcg_iters", 200)),
        min_eig_num_tol=cfg["eta"], verbose=True,
        checkpoint_path=checkpoint_path)
    elapsed = time.time() - t0
    P = g.problem_data(device=device)
    return dict(
        measurements=ds.pose_pose_measurements, X=res.X, d=d,
        result=dict(_result(res, elapsed),
                    f_rounded=float(prob.cost(P, res.rounded))),
        T_est=_trajectory(res.rounded, g.n), T_gt=_ground_truth(ds))


def run_ra(path, cfg, device="cuda", checkpoint_path=None):
    from dcora_tpu_torch.core import problem as prob
    from dcora_tpu_torch.drivers.single_robot_raslam import run as run_cora

    t0 = time.time()
    res, g, gm = run_cora(path, r_max=cfg["r_max"], min_eig_tol=cfg["eta"],
                          verbose=True, checkpoint_path=checkpoint_path,
                          device=device)
    elapsed = time.time() - t0
    P = g.problem_data(device=device)
    return dict(
        measurements=gm.relative_measurements, X=res.X, d=res.X.d,
        result=dict(_result(res, elapsed),
                    f_rounded=float(prob.cost(P, res.rounded))),
        T_est=_trajectory(res.rounded, g.n),
        T_gt=_trajectory(gm.ground_truth_init, g.n))


def run_dc2pgo(path, cfg, device="cuda", checkpoint_path=None):
    from dcora_tpu_torch.drivers.multi_robot_pgo import run as run_mr
    from dcora_tpu_torch.io import read_g2o_file

    ds = read_g2o_file(path)
    t0 = time.time()
    res = run_mr(cfg["robots"], path, r_min=cfg["r_min"],
                 r_max=cfg["r_max"], min_eig_num_tol=cfg["eta"],
                 num_iters=cfg.get("num_iters", 1000), device=device)
    return dict(
        measurements=ds.pose_pose_measurements, X=res.X, d=ds.dim,
        result=_rbcd_result(res, time.time() - t0),
        T_est=None, T_gt=_ground_truth(ds),
        cost_trace=res.cost_trace, gradnorm_trace=res.gradnorm_trace)


def run_dcora(path, cfg, device="cuda", checkpoint_path=None):
    from dcora_tpu_torch.drivers.multi_robot_raslam import run as run_mr_ra
    from dcora_tpu_torch.io import read_pyfg_file
    from dcora_tpu_torch.io.remap import get_global_measurements

    t0 = time.time()
    res = run_mr_ra(path, r_max=cfg["r_max"], min_eig_num_tol=cfg["eta"],
                    rgrad_norm_tol=cfg.get("tol", 0.1), device=device)
    elapsed = time.time() - t0
    gm = get_global_measurements(read_pyfg_file(path))
    return dict(
        measurements=gm.relative_measurements, X=res.X, d=res.X.d,
        result=_rbcd_result(res, elapsed), T_est=None, T_gt=None,
        cost_trace=res.cost_trace, gradnorm_trace=res.gradnorm_trace)


RUNNERS = dict(pgo=run_pgo, ra=run_ra, dc2pgo=run_dc2pgo, dcora=run_dcora)


def _save_state(name, X, state_dir=None):
    state_dir = state_dir or STATE_DIR
    os.makedirs(state_dir, exist_ok=True)
    np.savez_compressed(os.path.join(state_dir, f"{name}.npz"),
                        **{k: v.cpu().numpy() for k, v in
                           zip(("rot", "sph", "trn"), X)})


def _load_state(name, state_dir=None):
    import torch

    from dcora_tpu_torch.core.lifted import RAState

    with np.load(os.path.join(state_dir or STATE_DIR, f"{name}.npz")) as z:
        return RAState(*(torch.as_tensor(z[k], dtype=torch.float64)
                         for k in ("rot", "sph", "trn")))


def _downsample(trace, keep=400):
    """Bound committed artifact size: keep every Nth point plus the final
    value (a 4000-iteration run once inserted 33k JSON lines)."""
    trace = [float(x) for x in trace]
    if len(trace) <= keep:
        return trace
    step = -(-len(trace) // keep)
    out = trace[::step]
    if out[-1] != trace[-1]:
        out.append(trace[-1])
    return out


def _config_path(name, data_dir) -> str:
    path = os.path.join(data_dir, CONFIGS[name]["file"])
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def _config_measurements(name, data_dir):
    """The measurement list verify_solution needs, per config kind."""
    path = _config_path(name, data_dir)
    if CONFIGS[name]["kind"] in ("pgo", "dc2pgo"):
        from dcora_tpu_torch.io import read_g2o_file

        return read_g2o_file(path).pose_pose_measurements
    from dcora_tpu_torch.io import read_pyfg_file
    from dcora_tpu_torch.io.remap import get_global_measurements

    return get_global_measurements(read_pyfg_file(path)).relative_measurements


def reverify_config(name, data_dir, art=None, state_dir=None):
    """Re-run ONLY the independent verification against the saved final
    state and update the artifact's verification fields in place (after a
    verifier fix, a sound verdict needs no re-solve)."""
    from dcora_tpu_torch import verification as V

    art = art or ART
    ms = _config_measurements(name, data_dir)
    X = _load_state(name, state_dir)
    with open(os.path.join(art, f"{name}.json")) as fh:
        rec = json.load(fh)
    t_v = time.time()
    rep = V.verify_solution(ms, X, X.d, eta=CONFIGS[name]["eta"])
    rep["verify_indep_s"] = time.time() - t_v
    rec.update(rep)
    rec["reverified_timestamp"] = time.strftime("%Y-%m-%d %H:%M:%S")
    with open(os.path.join(art, f"{name}.json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    return rec


def run_config(name, data_dir, device="cuda", state_dir=None,
               checkpoint_dir: Optional[str] = None):
    """Solve one config on `device`, save its final state under
    `state_dir`, verify it independently; returns the record.  The RA
    staircase checkpoints into `checkpoint_dir` (default: the temporary
    directory), so a long run resumes when re-run."""
    from dcora_tpu_torch import verification as V
    from dcora_tpu_torch.core.device import resolve_device
    from dcora_tpu_torch.tools.common import platform

    cfg = CONFIGS[name]
    path = _config_path(name, data_dir)
    dev = resolve_device(device)
    ckpt = None
    if cfg["kind"] == "ra":
        ckpt = os.path.join(checkpoint_dir or tempfile.gettempdir(),
                            f"dcora_torch_ckpt_{os.path.basename(path)}.npz")
    out = RUNNERS[cfg["kind"]](path, cfg, dev, ckpt)
    _save_state(name, out["X"], state_dir)

    t_v = time.time()
    rep = V.verify_solution(out["measurements"], out["X"], out["d"],
                            eta=cfg["eta"])
    rep["verify_indep_s"] = time.time() - t_v
    rec = dict(cfg=dict(cfg), **out["result"], **rep)
    if out.get("T_est") is not None and out.get("T_gt") is not None \
            and len(out["T_est"]) == len(out["T_gt"]):
        rec["ate_vs_gt"] = V.ate_vs_ground_truth(out["T_est"], out["T_gt"])
    if "cost_trace" in out:
        rec["cost_trace"] = _downsample(out["cost_trace"])
        rec["gradnorm_trace"] = _downsample(out["gradnorm_trace"])
    rec["timestamp"] = time.strftime("%Y-%m-%d %H:%M:%S")
    rec["platform"] = platform(dev)
    return rec


SUMMARY_HEADER = """# PARITY — the PyTorch port's reference-parity records

Written by `python -m dcora_tpu_torch.tools.parity --summary` from
`artifacts/torch/parity/*.json`; each record was made by
`python -m dcora_tpu_torch.tools.parity --configs NAME` on the device its
`platform` column names (the card's name and power limit, or `cpu`): the
staircase or the RBCD driver of `dcora_tpu_torch`, rounding, and the
independent scipy re-verification (`dcora_tpu_torch/verification.py`),
which shares no code with the engine.  The protocol and the meaning of each
column are those of the JAX package's table (BASELINE_CAPTURED.md):
`certified (scipy)` is True only when an LDL^T inertia factorization proves
S + eta I >= 0; multi-robot rows report the reference's printed cost scale
2f, single-robot rows f = 0.5<XQ, X>.  The datasets are the generated test
sets (`datasets.ensure_test_datasets`) unless `--data-dir` named others.

"""


def summarize(art=None) -> str:
    art = art or ART
    rows = []
    for f in sorted(os.listdir(art)):
        if f.endswith(".json"):
            with open(os.path.join(art, f)) as fh:
                rows.append((f[:-5], json.load(fh)))
    lines = [
        "| config | platform | certified (engine) | certified (scipy) | "
        "LDL witness | rank | f* | f* (scipy Q) | indep gradnorm | "
        "indep min-eig | ATE vs GT | wall s |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for name, r in rows:
        ate = r.get("ate_vs_gt")
        f_final = r.get("f_final")
        lines.append(
            f"| {name} | {r.get('platform', '?')} | "
            f"{r.get('certified')} | {r.get('certified_indep')} | "
            f"{r.get('psd_proof_indep')} | "
            f"{r.get('final_rank')} | "
            f"{f_final if f_final is None else f'{f_final:.6f}'} | "
            f"{r['f_indep']:.6f} | {r['gradnorm_indep']:.2e} | "
            f"{r['min_eig_indep']:.2e} | "
            f"{'—' if ate is None else f'{ate:.4f}'} | "
            f"{r.get('elapsed_s', 0):.1f} |")
    return "\n".join(lines)


def summary_text(art=None) -> str:
    """PARITY.md as --summary writes it."""
    return SUMMARY_HEADER + summarize(art) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="*", default=[])
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    ap.add_argument("--data-dir", default=None,
                    help="dataset directory (default: $DCORA_DATA_DIR, "
                    "else the generated test sets)")
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--reverify", action="store_true",
                    help="re-run ONLY the independent verification of the "
                    "named configs against their saved final states")
    args = ap.parse_args(argv)

    if args.summary:
        with open(SUMMARY, "w") as fh:
            fh.write(summary_text())
        print(summarize())
        return

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    data_dir = args.data_dir or default_data_dir()
    os.makedirs(ART, exist_ok=True)
    for name in args.configs:
        print(f"=== {'reverify ' if args.reverify else ''}{name} ===",
              flush=True)
        if args.reverify:
            rec = reverify_config(name, data_dir)
        else:
            rec = run_config(name, data_dir, args.device)
            with open(os.path.join(ART, f"{name}.json"), "w") as fh:
                json.dump(rec, fh, indent=1)
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("cost_trace", "gradnorm_trace")},
                         indent=1), flush=True)


if __name__ == "__main__":
    main()
