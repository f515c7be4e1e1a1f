"""g2o100k: the 97,336-pose certified solve on one card, with the wall-clock
breakdown of every certification part.

Counterpart of the JAX package's ``tools/g2o100k_certify.py``.  BASELINE's
north-star problem is a g2o100k-class pose graph (10x the reference's
largest bundled benchmark, city10000).  This runs the centralized pipeline
on the generated 46^3 grid (``datasets.generate_large_scale_g2o``, 97,336
poses, seed 100): the reader, chordal init on the device, the mixed-
precision staircase (f32 tiles -> f64 tiles -> f64 edge path; every tile
product one launch of the strip kernel) with its NPZ checkpoint, so that
re-running the command resumes, then, at the final X (k = 4n = 389,344):

  * the dual certificate blocks Lambda(X) on the device (synchronized);
  * the host assembly of S = Q - Lambda(X) (scipy CSR);
  * the LDL^T inertia proof of S + eta I (SuperLU; the PSD quick return of
    the reference's isSparseSymmetricMatrixPSD, DCORA_utils.cpp:1737-1747);
  * the fail-closed host min-eig path (certify._min_eig_host);
  * the independent scipy re-verification (verification.verify_solution).

Each part is timed with ``utils.timing`` and its host peak RSS sampled.
The record is rewritten at every step, at every log line of the solver
(kept under "log") and every 30 s, with ``"in_progress": true``, the step
it is in, the seconds since the start and the resident set, so a run cut
by a time limit leaves a record of where it stopped and how long it had
run; the finished record has ``"in_progress": false``.  It carries the
card's name and power limit (``nvidia-smi``), or "cpu".

Usage:
  python -m dcora_tpu_torch.tools.g2o100k_certify [--device cuda|cpu]
      [--rmin 5] [--rmax 8] [--tcg 50] [--eta 1e-3] [--out FILE]
      [--checkpoint FILE] [--state FILE]

Writes artifacts/torch/g2o100k_certify.json and the final state
artifacts/torch/state/g2o100k.npz (gitignored).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import resource
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ART = os.path.join(REPO, "artifacts", "torch")
# the JAX tool's cache of the generated file
CACHE = os.path.join(os.path.expanduser("~"), ".cache", "dcora_tpu")


def _rss_gb() -> float:
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


@contextmanager
def rss_peak(out: dict, key: str, every_s: float = 0.2):
    """Samples this process's resident set while the block runs; stores
    its peak in GB under out[key]."""
    peak, stop = [_rss_gb()], threading.Event()

    def sample():
        while not stop.wait(every_s):
            peak[0] = max(peak[0], _rss_gb())

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield
    finally:
        stop.set()
        th.join()
        out[key] = max(peak[0], _rss_gb())


class _Record(logging.Handler):
    """The record as it grows, written to `out` (when given) at every
    update, every log line of the package and every `every_s` seconds."""

    def __init__(self, rec: dict, out: Optional[str], every_s: float = 30.0):
        super().__init__(logging.INFO)
        self.rec, self.out, self.t0 = rec, out, time.time()
        self.rss_peak = 0.0
        self.write_lock = threading.Lock()
        self.stop = threading.Event()
        self.every_s = every_s
        self.thread = threading.Thread(target=self._beat, daemon=True)

    def __enter__(self):
        self.rec["log"] = []
        logging.getLogger("dcora_tpu_torch").addHandler(self)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        logging.getLogger("dcora_tpu_torch").removeHandler(self)
        self.write()

    def _beat(self):
        while not self.stop.wait(self.every_s):
            self.write()

    def emit(self, record):
        self.rec["log"].append(
            f"{time.time() - self.t0:.1f}s {record.getMessage()}")
        self.write()

    def step(self, name: str):
        self.rec["step"] = name
        self.rec["step_started_s"] = time.time() - self.t0
        self.write()

    def write(self):
        with self.write_lock:
            rss = _rss_gb()
            self.rss_peak = max(self.rss_peak, rss)
            self.rec.update(elapsed_s=time.time() - self.t0, rss_now_gb=rss,
                            rss_peak_sampled_gb=self.rss_peak,
                            timestamp=time.strftime("%Y-%m-%d %H:%M:%S"))
            if not self.out:
                return
            os.makedirs(os.path.dirname(os.path.abspath(self.out)),
                        exist_ok=True)
            tmp = self.out + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self.rec, fh, indent=1, default=str)
            os.replace(tmp, self.out)


def run(path: str, rmin: int = 5, rmax: int = 8, tcg: int = 50,
        eta: float = 1e-3, device="cuda",
        checkpoint_path: Optional[str] = None, out: Optional[str] = None,
        state_path: Optional[str] = None) -> dict:
    """The tool's body on the g2o file at `path`; returns the record (also
    written to `out` as it grows, when given)."""
    rec: dict = {}
    with _Record(rec, out) as log:
        _run(log, path, rmin, rmax, tcg, eta, device, checkpoint_path,
             state_path)
    return rec


def _run(log: _Record, path, rmin, rmax, tcg, eta, device, checkpoint_path,
         state_path):
    import scipy.sparse as sp

    from dcora_tpu_torch import verification as V
    from dcora_tpu_torch.core import lifted, problem as prob, spmm
    from dcora_tpu_torch.core.certify import (
        _assemble_S_host,
        _min_eig_host,
        dual_certificate_blocks,
        ldl_psd_proof,
    )
    from dcora_tpu_torch.core.device import resolve_device
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.core.init import chordal_initialization
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.solvers import precond_build
    from dcora_tpu_torch.staircase import riemannian_staircase
    from dcora_tpu_torch.tools.common import platform
    from dcora_tpu_torch.types import ROptParameters
    from dcora_tpu_torch.utils.timing import PhaseTimer, SimpleTimer

    dev = resolve_device(device)
    pt = PhaseTimer()
    rec, step = log.rec, log.step
    rec.update({"dataset": os.path.basename(path), "platform": platform(dev),
                "device": str(dev), "torch": torch.__version__,
                "params": dict(rmin=rmin, rmax=rmax, tcg=tcg, eta=eta,
                               gradnorm_tol=1e-4, rtr_iters=200),
                "in_progress": True})

    def seconds(name):
        return pt.ms[name] / 1e3

    step("read")
    with rss_peak(rec, "rss_peak_read_gb"), pt.phase("parse"):
        ds = read_g2o_file(path)
    rec["t_parse_s"] = seconds("parse")
    rec["reader"] = ds.reader
    d, n = ds.dim, ds.num_poses
    ms = ds.pose_pose_measurements
    rec["n_poses"], rec["n_edges"] = n, len(ms)

    step("chordal_init")
    g = LocalGraph(0, rmin, d)
    g.set_measurements(ms)
    iters: list = []
    with pt.phase("init"):
        T0 = chordal_initialization(ms, device=dev, cg_iters=iters)
    rec["t_chordal_init_s"] = seconds("init")
    rec["chordal_cg_iters"] = iters

    step("staircase")
    X0 = lifted.pad_rank(lifted.from_pose_array(T0, device=dev), rmin)
    spmm.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with rss_peak(rec, "rss_peak_solve_gb"):
        with pt.phase("solve"):
            res = riemannian_staircase(
                g, X0, r_min=rmin, r_max=rmax,
                opt_params=ROptParameters(gradnorm_tol=1e-4,
                                          RTR_iterations=200,
                                          RTR_tCG_iterations=tcg),
                min_eig_num_tol=eta, verbose=True,
                checkpoint_path=checkpoint_path)
    rec["t_solve_s"] = seconds("solve")
    rec["launches"] = spmm.launch_counts()
    rec["precond"] = precond_build()
    if dev.type == "cuda":
        rec["device_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if state_path:
        os.makedirs(os.path.dirname(os.path.abspath(state_path)),
                    exist_ok=True)
        np.savez_compressed(state_path,
                            **{k: v.cpu().numpy() for k, v in
                               zip(("rot", "sph", "trn"), res.X)})
    P = g.problem_data(device=dev)
    rec.update(certified=bool(res.certified), final_rank=int(res.final_rank),
               f_final=float(res.f_final),
               f_rounded=float(prob.cost(P, res.rounded)),
               gradnorm_final=float(res.gradnorm_final),
               min_eig_history=[float(x) for x in res.min_eig_history],
               stage_seconds=res.stage_seconds)

    # ---- certification wall-clock breakdown at the final X ----
    dims = res.X.dims
    k = dims.k
    rec["k"] = int(k)
    step("lambda_device")
    timer = SimpleTimer()
    timer.tic()
    C = dual_certificate_blocks(P, res.X)
    rec["t_lambda_device_s"] = timer.toc(block_on=C) / 1e3
    step("S_assemble")
    with rss_peak(rec, "rss_peak_S_gb"), pt.phase("S"):
        S = _assemble_S_host(P, C, dims)
    rec["t_S_assemble_s"] = seconds("S")
    rec["S_nnz"] = int(S.nnz)

    step("ldl_proof")
    with rss_peak(rec, "rss_peak_ldl_gb"), pt.phase("ldl"):
        proof = ldl_psd_proof(S + eta * sp.identity(k, format="csr"))
    rec["t_ldl_proof_s"] = seconds("ldl")
    rec["ldl_proof"] = proof
    del S

    step("min_eig_host")
    with rss_peak(rec, "rss_peak_min_eig_gb"), pt.phase("min_eig"):
        cert_host, lam_host, _ = _min_eig_host(P, C, dims, eta)
    rec["t_min_eig_host_s"] = seconds("min_eig")
    rec["min_eig_host_certified"] = bool(cert_host)
    rec["min_eig_host_theta"] = float(lam_host)

    # ---- independent scipy re-verification (shares no engine code) ----
    step("verify_indep")
    with rss_peak(rec, "rss_peak_verify_gb"), pt.phase("verify"):
        rep = V.verify_solution(ms, res.X, d, eta=eta)
    rec["t_verify_indep_s"] = seconds("verify")
    rec.update(rep)
    rec["rss_max_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6
    rec["in_progress"] = False
    step("done")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    ap.add_argument("--rmin", type=int, default=5)
    ap.add_argument("--rmax", type=int, default=8)
    ap.add_argument("--tcg", type=int, default=50,
                    help="tCG budget per outer (the reference's RBCD "
                    "default, ROptParameters DCORA_types.h:166-168)")
    ap.add_argument("--eta", type=float, default=1e-3)
    ap.add_argument("--out", default=os.path.join(ART,
                                                  "g2o100k_certify.json"))
    ap.add_argument("--checkpoint", default=os.path.join(
        tempfile.gettempdir(), "dcora_ckpt_g2o100k.npz"),
        help="staircase checkpoint; an existing one is resumed")
    ap.add_argument("--state", default=os.path.join(ART, "state",
                                                    "g2o100k.npz"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    from dcora_tpu_torch.datasets import generate_large_scale_g2o

    path = os.path.join(CACHE, "g2o100k.g2o")
    if not os.path.exists(path):
        os.makedirs(CACHE, exist_ok=True)
        print("generating g2o100k ...", flush=True)
        generate_large_scale_g2o(path)
    rec = run(path, args.rmin, args.rmax, args.tcg, args.eta, args.device,
              checkpoint_path=args.checkpoint, out=args.out,
              state_path=args.state)
    print(json.dumps(rec, indent=1, default=str), flush=True)


if __name__ == "__main__":
    main()
