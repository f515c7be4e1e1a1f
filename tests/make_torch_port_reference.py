"""Write tests/data/torch_port_{pgo,ra}_reference.json from the JAX package.

The PyTorch port (dcora_tpu_torch) is held to the certified rank and f* that
the JAX reference reaches on the same generated pose graphs and RA-SLAM
sets.  The machine that runs the port has no JAX, so this script records
the reference values once, on the CPU:

    DCORA_PLATFORM=cpu JAX_PLATFORMS=cpu python tests/make_torch_port_reference.py [NAME ...]

Each entry names its generator call, so the consumer (chip_smoke.py)
regenerates a bit-identical file from the same seed, and records its CPU
seconds.  The 10,648-pose grid takes roughly twelve minutes on a CPU and
the 500-pose RA set about seven; run them in the background.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from dcora_tpu_torch.tools.common import RA_KW  # noqa: E402

OUT = os.path.join(HERE, "data", "torch_port_pgo_reference.json")
OUT_RA = os.path.join(HERE, "data", "torch_port_ra_reference.json")

# name -> (generator function name, keyword arguments)
CASES = {
    "smallGrid3D": ("generate_grid_g2o",
                    dict(shape=[5, 5, 5], rot_noise=0.05, trans_noise=0.02,
                         seed=12)),
    "grid10k": ("generate_large_scale_g2o", dict(target_poses=10_000)),
    "ra500": ("generate_ra_slam_pyfg", dict(RA_KW, poses_per_robot=100)),
    "ra10k": ("generate_ra_slam_pyfg", dict(RA_KW, poses_per_robot=1950)),
}
RA_R_MAX = 20
RA_ETA = 1e-4  # min_eig_tol of single_robot_raslam.run and the witness


def solve(path: str):
    """The certify branch of dcora_tpu.drivers.single_robot_pgo.run, with
    the staircase result kept (run() returns only the trajectory and f)."""
    from dcora_tpu.core import lifted, problem as prob
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.init import chordal_initialization
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.staircase import riemannian_staircase
    from dcora_tpu.types import ROptParameters
    from dcora_tpu.verification import verify_solution

    ds = read_g2o_file(path)
    ms = ds.pose_pose_measurements
    d = ds.dim
    params = ROptParameters(gradnorm_tol=1e-4, RTR_iterations=200,
                            RTR_tCG_iterations=200)
    g = LocalGraph(0, d + 2, d)
    g.set_measurements(ms)
    T = chordal_initialization(ms)
    X0 = lifted.pad_rank(lifted.from_pose_array(T), d + 2)
    res = riemannian_staircase(g, X0, r_min=d + 2, r_max=20,
                               opt_params=params, min_eig_num_tol=1e-3)
    f = float(prob.cost(g.problem_data(), res.rounded))
    rep = verify_solution(ms, res.X, d, eta=1e-3)
    return dict(n=g.n, m=len(ms), certified=bool(res.certified),
                rank=int(res.final_rank), f=f,
                f_lifted=float(res.f_final),
                ldl_witness=bool(rep["certified_indep"]))


def solve_ra(path: str):
    """dcora_tpu.drivers.single_robot_raslam.run with its defaults (odometry
    init, r_max 20, eta 1e-4), plus the independent LDL^T witness."""
    from dcora_tpu.core import problem as prob
    from dcora_tpu.drivers.single_robot_raslam import run
    from dcora_tpu.verification import verify_solution

    res, g, gm = run(path, r_max=RA_R_MAX, min_eig_tol=RA_ETA, verbose=False)
    f = float(prob.cost(g.problem_data(), res.rounded))
    rep = verify_solution(gm.relative_measurements, res.X, g.d, eta=RA_ETA)
    return dict(n=g.n, l=g.dims.l, b=g.dims.b,
                m=len(gm.relative_measurements),
                certified=bool(res.certified), rank=int(res.final_rank),
                f=f, f_lifted=float(res.f_final),
                gradnorm=float(res.gradnorm_final),
                ldl_witness=bool(rep["certified_indep"]),
                gradnorm_indep=float(rep["gradnorm_indep"]),
                r_max=RA_R_MAX, eta=RA_ETA)


def main(names=None):
    import dcora_tpu  # noqa: F401  (x64 on)
    from dcora_tpu import datasets

    with tempfile.TemporaryDirectory() as tmp:
        for name in names or CASES:
            gen, kw = CASES[name]
            ra = gen == "generate_ra_slam_pyfg"
            path = os.path.join(tmp, name + (".pyfg" if ra else ".g2o"))
            call = dict(kw)
            if "shape" in call:
                call["shape"] = tuple(call["shape"])
            getattr(datasets, gen)(path, **call)
            t0 = time.time()
            rec = (solve_ra if ra else solve)(path)
            rec["generator"] = gen
            rec["kwargs"] = kw
            rec["seconds"] = round(time.time() - t0, 1)
            print(name, rec, flush=True)
            dest = OUT_RA if ra else OUT
            out = {}
            if os.path.exists(dest):  # re-read: another run may have written
                with open(dest) as fh:
                    out = json.load(fh)
            out[name] = rec
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "w") as fh:
                json.dump(out, fh, indent=1, sort_keys=True)
                fh.write("\n")


if __name__ == "__main__":
    np.set_printoptions(precision=12)
    main(sys.argv[1:] or None)
