"""How far the GNC solves of each engine move when only its host path
changes: the native (C++) reader and block-Jacobi build against the numpy
ones, whose numbers differ in the last ulps.

The spread of the JAX package against itself is what the gates of the
port's native-path GNC tests rest on (tests/test_torch_robust.py,
tests/test_torch_multi_robot.py).  For each corruption seed the script
runs both engines on both host paths and prints one JSON row per pair:

    JAX_PLATFORMS=cpu python tests/gnc_host_path_spread.py robust 7 8 9 10 11
    JAX_PLATFORMS=cpu python tests/gnc_host_path_spread.py distributed 7 8 9

``robust``: solve_robust_pgo on smallGrid3D with 15 % planted outliers
(largest weight gap ``w_max``, trajectory gap with pose 0 at the identity
over the largest coordinate ``traj_rel``), about a minute per seed.
``distributed``: the multi-robot GNC on smallGrid3D with 10 % outliers,
3 robots (largest relative gap of the round costs up to the first weight
update ``cost_rel_first``, of the last round ``cost_rel_last``, weight gap
``w_max``, and whether rank, iterations and verdict agree ``same``), about
a minute per seed.  The data are the generated test sets
(``$DCORA_DATA_DIR``, else ``.data_cache`` at the repo root).

The host's threads move the JAX package too: XLA's CPU backend splits its
products over a thread pool unless told not to.  ``traces`` writes the
distributed runs' round costs up to the first weight update, for both
engines on both host paths, to a JSON file; ``spread`` compares every pair
of traces across such files, so across processes started with other
``XLA_FLAGS`` or torch thread counts (``--torch-threads``, default 1 as
the tests):

    JAX_PLATFORMS=cpu python tests/gnc_host_path_spread.py traces a.json 7
    XLA_FLAGS="--xla_cpu_multi_thread_eigen=false \
        intra_op_parallelism_threads=1" JAX_PLATFORMS=cpu \
        python tests/gnc_host_path_spread.py traces b.json 7
    python tests/gnc_host_path_spread.py spread a.json b.json

``traces --robust`` writes solve_robust_pgo's final weights and gauged
trajectory instead, and ``spread`` then prints ``w_max`` and
``traj_rel`` of every pair.

Measured on an 8-core x86 host (CPU runs, seed 7, behind the gate of
test_distributed_gnc_matches_jax): ``cost_rel_first`` of

    JAX native, default threading vs one thread          1.35e-8
    JAX numpy, default threading vs one thread           5.2e-9
    JAX native vs numpy, default threading               5.2e-9
    JAX native vs numpy, one thread                      2.13e-8
    JAX native one thread vs numpy default               1.84e-8
    port native vs numpy (torch threads 1 or 4)          1.38e-8
    port, torch threads 1 vs 4 (either path)             0
    port numpy vs JAX native, default threading          1.53e-8
    port numpy vs JAX native, one thread                 2.87e-8
    port native vs JAX native, either threading          3.8e-9 / 1.50e-8

and, with ``--robust`` (behind test_solve_robust_pgo_matches_jax), the
largest ``w_max`` / ``traj_rel`` at seed 7 of

    JAX against itself (two threadings, two host paths)  1.39e-5 / 6.12e-8
    port native vs numpy (either threading)              1.37e-5 / 2.88e-8
    port numpy vs JAX native, default threading          1.22e-5 / 2.87e-8
    port numpy vs JAX native, one thread                 6.32e-6 / 2.15e-8
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import dcora_tpu.datasets as jds  # noqa: E402
import dcora_tpu.native as jnative  # noqa: E402
from dcora_tpu.core import manifold as jmanifold  # noqa: E402
from dcora_tpu.io import read_g2o_file as jread  # noqa: E402

_JAX_AVAILABLE = jnative.available
PAIRS = [(("J", 1), ("J", 0)), (("T", 1), ("T", 0)), (("T", 1), ("J", 1)),
         (("T", 0), ("J", 1)), (("T", 0), ("J", 0)), (("T", 1), ("J", 0))]


def _name(key):
    return f"{'jax' if key[0] == 'J' else 'port'}-" \
           f"{'native' if key[1] else 'numpy'}"


def _host_path(engine, native):
    """Switch one engine's host path; the other engine's stays native."""
    jnative.available = _JAX_AVAILABLE
    os.environ.pop("DCORA_NATIVE", None)
    if not native:
        if engine == "J":
            jnative.available = lambda: False
        else:
            os.environ["DCORA_NATIVE"] = "0"


def _robust(data, seed, engine):
    import dcora_tpu.solvers as jsolvers
    import dcora_tpu.types as jtypes
    import dcora_tpu_torch.measurements as tmeas
    import dcora_tpu_torch.solvers as tsolvers
    import dcora_tpu_torch.types as ttypes
    from dcora_tpu_torch.core.lifted import pose_inverse, pose_multiply

    clean = jread(os.path.join(data, "smallGrid3D.g2o"))
    ms, _ = jds.corrupt_with_outliers(clean.pose_pose_measurements,
                                      frac=0.15, seed=seed)
    types, solvers = (jtypes, jsolvers) if engine == "J" else \
        (ttypes, tsolvers)
    params = solvers.SolveRobustPGOParams(
        opt_params=types.ROptParameters(gradnorm_tol=1e-9,
                                        RTR_iterations=50),
        robust_params=types.RobustCostParameters(
            costType=types.RobustCostType.GNC_TLS, GNCMaxNumIters=6))
    if engine == "J":
        T = jsolvers.solve_robust_pgo(ms, params)
    else:
        ms = [tmeas.RelativePosePoseMeasurement(
            m.r1, m.p1, m.r2, m.p2, m.R, m.t, m.kappa, m.tau,
            weight=m.weight, fixedWeight=m.fixedWeight) for m in ms]
        T = tsolvers.solve_robust_pgo(ms, params, device="cpu")
    T = np.asarray(T)
    inv = pose_inverse(T[0])
    return dict(w=np.array([m.weight for m in ms]),
                gauge=np.stack([pose_multiply(inv, Ti) for Ti in T]),
                scale=float(np.abs(T).max()))


def _distributed(data, seed, engine, tmp):
    from dcora_tpu.drivers import multi_robot_pgo as jmr
    from dcora_tpu.types import InitializationMethod as JI
    from dcora_tpu.types import RobustCostParameters as JRP
    from dcora_tpu.types import RobustCostType as JRT
    from dcora_tpu_torch.drivers import multi_robot_pgo as tmr
    from dcora_tpu_torch.types import InitializationMethod as TI
    from dcora_tpu_torch.types import RobustCostParameters as TRP
    from dcora_tpu_torch.types import RobustCostType as TRT

    ds = jread(os.path.join(data, "smallGrid3D.g2o"))
    corrupted, _ = jds.corrupt_with_outliers(ds.pose_pose_measurements,
                                             frac=0.1, seed=seed)
    path = jds.write_g2o(os.path.join(tmp, f"c{seed}.g2o"), corrupted,
                         ds.dim)
    kw = dict(num_iters=120, r_max=5, robust_inner_iters=10,
              robust_weight_updates=3)
    if engine == "J":
        r = jmr.run(3, path, init_method=JI.Chordal,
                    robust_cost_params=JRP(costType=JRT.GNC_TLS), **kw)
    else:
        r = tmr.run(3, path, init_method=TI.Chordal,
                    robust_cost_params=TRP(costType=TRT.GNC_TLS),
                    device="cpu", lifting_matrix=lambda k: np.asarray(
                        jmanifold.fixed_lifting_matrix(k, 3)), **kw)
    return dict(cost=np.asarray(r.cost_trace),
                w=np.array([r.weights[k] for k in sorted(r.weights)]),
                verdict=(r.certified, r.final_rank, r.total_iters),
                first=5 * kw["robust_inner_iters"])


def _compare(kind, a, b):
    if kind == "robust":
        return dict(w_max=float(np.abs(a["w"] - b["w"]).max()),
                    traj_rel=float(np.abs(a["gauge"] - b["gauge"]).max())
                    / b["scale"])
    f = a["first"]
    ca, cb = a["cost"], b["cost"]
    return dict(cost_rel_first=float(np.max(np.abs(ca[:f] - cb[:f])
                                            / np.abs(cb[:f]))),
                cost_rel_last=float(abs(ca[-1] - cb[-1]) / abs(cb[-1])),
                w_max=float(np.abs(a["w"] - b["w"]).max()),
                same=a["verdict"] == b["verdict"])


def _traces(data, out, seeds, threads, kind="distributed"):
    """With this process's threading, to `out`: the distributed runs'
    round costs up to the first weight update, {engine-path: {seed:
    [cost]}}; or, for kind "robust", solve_robust_pgo's final weights and
    its trajectory with pose 0 at the identity over the largest coordinate,
    {engine-path: {seed: {"w": [...], "traj": [...]}}}."""
    torch.set_num_threads(threads)
    rec = dict(kind=kind, xla_flags=os.environ.get("XLA_FLAGS", ""),
               torch_threads=threads, traces={})
    with tempfile.TemporaryDirectory() as tmp:
        for seed in seeds:
            for engine in "JT":
                for native in (1, 0):
                    _host_path(engine, native)
                    if kind == "robust":
                        r = _robust(data, seed, engine)
                        tr = dict(w=r["w"].tolist(), traj=(
                            r["gauge"] / r["scale"]).ravel().tolist())
                    else:
                        r = _distributed(data, seed, engine, tmp)
                        tr = r["cost"][:r["first"]].tolist()
                    rec["traces"].setdefault(_name((engine, native)), {})[
                        str(seed)] = tr
    _host_path("J", 1)
    with open(out, "w") as fh:
        json.dump(rec, fh)


def _gaps(a, b) -> dict:
    """The gaps between two traces of one seed: cost_rel_first of the
    distributed round costs, or w_max and traj_rel of the robust GNC."""
    if isinstance(a, dict):
        return dict(w_max=float(np.abs(np.subtract(a["w"], b["w"])).max()),
                    traj_rel=float(np.abs(np.subtract(a["traj"],
                                                      b["traj"])).max()))
    ca, cb = np.asarray(a), np.asarray(b)
    return dict(cost_rel_first=float(np.max(np.abs(ca - cb) / np.abs(cb))))


def _spread(files):
    """The gaps of every pair of traces across `files` (of one kind), one
    JSON row per pair and seed."""
    runs = []
    for f in files:
        with open(f) as fh:
            rec = json.load(fh)
        tag = f"{os.path.basename(f)} (XLA_FLAGS '{rec['xla_flags']}', " \
              f"torch threads {rec['torch_threads']})"
        runs += [(tag, name, tr) for name, tr in rec["traces"].items()]
    for i, (ta, na, a) in enumerate(runs):
        for tb, nb, b in runs[i + 1:]:
            for seed in sorted(set(a) & set(b), key=int):
                print(json.dumps(dict(seed=int(seed), a=f"{na} {ta}",
                                      b=f"{nb} {tb}",
                                      **_gaps(a[seed], b[seed]))),
                      flush=True)


def main(argv):
    kind = argv[0]
    if kind == "spread":
        return _spread(argv[1:])
    threads = 1
    if "--torch-threads" in argv:
        i = argv.index("--torch-threads")
        threads = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    assert jnative.available(), "the JAX package's native library is absent"
    torch.set_num_threads(threads)
    data = os.environ.get("DCORA_DATA_DIR") or jds.ensure_test_datasets(
        os.path.join(ROOT, ".data_cache"))
    if kind == "traces":
        robust = "--robust" in argv
        argv = [a for a in argv if a != "--robust"]
        return _traces(data, argv[1], [int(s) for s in argv[2:]], threads,
                       "robust" if robust else "distributed")
    seeds = [int(s) for s in argv[1:]]
    assert kind in ("robust", "distributed"), kind
    with tempfile.TemporaryDirectory() as tmp:
        for seed in seeds:
            runs = {}
            for engine in "JT":
                for native in (1, 0):
                    _host_path(engine, native)
                    runs[(engine, native)] = (
                        _robust(data, seed, engine) if kind == "robust"
                        else _distributed(data, seed, engine, tmp))
            _host_path("J", 1)
            for a, b in PAIRS:
                print(json.dumps(dict(kind=kind, seed=seed, a=_name(a),
                                      b=_name(b),
                                      **_compare(kind, runs[a], runs[b]))),
                      flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
