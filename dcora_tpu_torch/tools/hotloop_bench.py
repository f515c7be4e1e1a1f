"""Per-op timing of the flat RTR / tCG hot loop on one CUDA device.

    python -m dcora_tpu_torch.tools.hotloop_bench [file.g2o] [--rank 5]
        [--pack bucketed|paired] [--outers 10] [--out result.json]

Counterpart of ``tools/hotloop_bench.py``.  On the f32 tiles of one graph
(default: the generated 10,648-pose grid) it times each op of the tCG inner
iteration -- the SpMM, ``tangent_project_flat`` and the Hessian chain
(``csrc/flat_ops.cu``'s flat_rhess), ``precond_project`` (its
flat_precond), the dots and axpys, ``retract_flat`` -- as CUDA-event ms
per call over back-to-back calls
(device time; PyTorch issues each op eagerly, so a call also pays its host
launch cost, which the sum of these does not show).  Then it times full
``rtr`` outer iterations on FLAT_BACKEND (50 tCG, no early stop) on the
host clock (its tCG iterations replay the flat CUDA graph).  ``--pack
paired`` runs the SpMM on the two-row K-fused
buckets, ``bucketed`` on the owner-computes CSR kernel.  The JAX tool's
planar variant has no counterpart: the planar layout is not ported.
Refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from dcora_tpu_torch.core import lifted, spmm, tiled
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import odometry_initialization
from dcora_tpu_torch.core.rtr import FLAT_BACKEND, RTRConfig, rtr
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.tools import common


def _vdot(a, b):
    return torch.sum(a * b)


def run(path: str, rank: int = 5, pack: str = "bucketed", outers: int = 10,
        verbose: bool = True) -> dict:
    common.require_cuda("hotloop_bench")
    r_pad = -(-rank // 8) * 8
    ds = read_g2o_file(path)
    g = LocalGraph(0, rank, ds.dim)
    g.set_measurements(ds.pose_pose_measurements)
    TP = tiled.build_tiled(g.problem_data(device="cuda"), g.dims,
                           dtype=torch.float32, pack=pack)
    meta = TP.meta
    rng = np.random.default_rng(0)
    Xf = torch.as_tensor(rng.standard_normal((r_pad, meta.kpad)),
                         dtype=torch.float32, device="cuda")
    Xf = tiled.retract_flat(meta, torch.zeros_like(Xf), Xf)
    egrad = tiled.egrad_flat(TP, Xf)
    aux = tiled.weingarten_setup(meta, Xf, egrad)
    V = 1e-3 * Xf

    ops = {
        "apply_tiled (SpMM)": lambda: tiled.apply_tiled(TP, V),
        "tangent_project_flat (flat_rhess)": lambda:
            tiled.tangent_project_flat(meta, Xf, V),
        "precond_project (flat_precond)": lambda: tiled.precond_project(
            TP, Xf, V),
        "hessvec chain (SpMM + flat_rhess)": lambda: FLAT_BACKEND.rhess(
            TP, Xf, V, aux),
        "dots + axpys (x3)": lambda: (
            V * (1.0 / (1e-8 + _vdot(V, V)))
            + 0.1 * V * _vdot(V, Xf) + 1e-3 * Xf * _vdot(V, V)),
        "retract_flat": lambda: tiled.retract_flat(meta, Xf, V),
    }
    res = dict(device=torch.cuda.get_device_name(0),
               nvidia_smi=common.card(), dataset=os.path.basename(path),
               n=g.dims.n, rank=rank, pack=pack, ops_us={})
    if verbose:
        print(f"{res['dataset']} n={res['n']} rank={rank} pack={pack} on "
              f"{res['nvidia_smi']}")
    for name, t in zip(ops, common.time_turns_ms(list(ops.values()))):
        res["ops_us"][name] = t * 1e3
        if verbose:
            print(f"  {name:44s} {t * 1e3:9.1f} us")

    # full RTR outer iterations (fixed 50 tCG inners, no early stop)
    cfg = RTRConfig(gradnorm_tol=1e-300, max_outer=outers, max_inner=50,
                    kappa=1e-300, theta=100.0)
    T0 = odometry_initialization(
        [m for m in ds.pose_pose_measurements if m.p1 + 1 == m.p2])
    X0 = lifted.pad_rank(lifted.from_pose_array(T0, device="cuda"), rank)
    Xf0 = tiled.to_flat(TP, X0, r_pad=r_pad).float()
    rtr(TP, None, None, Xf0, cfg, be=FLAT_BACKEND)  # warm-up
    torch.cuda.synchronize()
    spmm.reset_launches()
    t0 = time.perf_counter()
    out = rtr(TP, None, None, Xf0, cfg, be=FLAT_BACKEND)
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    res.update(rtr_outer=out.outer_iters, rtr_s=el,
               rtr_ms_per_outer=el / max(out.outer_iters, 1) * 1e3,
               rtr_f=float(out.f_final),
               rtr_gradnorm=float(out.gradnorm_final),
               rtr_launches=spmm.launch_counts())
    if verbose:
        print(f"  rtr (FLAT_BACKEND, {pack}): {out.outer_iters} outer x <=50 "
              f"tCG: {el * 1e3:.1f} ms total, "
              f"{res['rtr_ms_per_outer']:.2f} ms/outer, "
              f"f={res['rtr_f']:.4f} g={res['rtr_gradnorm']:.3e}; kernel "
              f"launches {res['rtr_launches']}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("g2o", nargs="?", default="",
                    help="dataset (default: the generated 10,648-pose grid)")
    ap.add_argument("--rank", type=int, default=5)
    ap.add_argument("--pack", choices=("bucketed", "paired"),
                    default="bucketed")
    ap.add_argument("--outers", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    common.require_cuda("hotloop_bench")
    with tempfile.TemporaryDirectory() as tmp:
        path = args.g2o or common.default_grid(tmp)
        res = run(path, rank=args.rank, pack=args.pack, outers=args.outers)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
