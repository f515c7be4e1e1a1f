"""The flat tiled path timed in two checkouts, in turns.

    python tools/flat_ab.py OTHER_TREE [--out FILE] [--no-gnc]

OTHER_TREE is another checkout of the repository (the parent commit, say,
unpacked with ``git archive`` into ``checkouts/``, which ``.gitignore``
lists).  The script runs four turns, other, this, this, other, each in a
process of its own that imports the ``dcora_tpu_torch`` of its tree; the
set-up and timing helpers come from this checkout's
``dcora_tpu_torch/tools/common.py`` (loaded by path), so both trees are
driven by the same code.  Per turn, on the card:

  * the SHA-256 of every kernel mode's output (``tiled.flat_rhess`` with
    the Weingarten term, ``tangent_project_flat``, the Hessian without
    the projection, ``weingarten_setup``'s Grams, ``flat_precond``) and of
    its inputs, on the layouts of grid10k, ra10k (spheres, landmarks),
    par_grid10k's stack of 8 agents and g2o100k (97,336 poses), in f32 and
    f64 at r_pad 8 and 16; the operands are random (one fixed seed, zero
    rows from rank 5 on, random Jacobi inverses), so only the layout comes
    from each problem, and g2o100k's is written out rather than built.
    Every turn must give the same hashes: two trees whose kernels give the
    same bits in every mode;
  * each kernel's device ms per launch (torch.profiler) on those layouts,
    flat_rhess with the Weingarten term and flat_precond, beside the
    device ms of the least launch, a one-element ``fill_``;
  * the ms per iteration of a 100-iteration flat tCG solve
    (``rtr.truncated_cg`` on ``rtr.FLAT_BACKEND``) at r_pad 8 from a
    random point on the manifold, with the Hessian's Weingarten term left
    out so that it runs all its iterations (CUDA events around whole
    solves, host issue included, median of 3 turns), on grid10k's f32 and
    f64 tiles at rank 5 (per-pose Jacobi, as the PGO tile phases) and on
    ra10k's f32 tiles at rank 3 (BTD, as the RA tile phases): the
    iterations issued one by one ("eager"; in a tree whose flat ops are
    einsums, those) and, in a tree that has ``rtr.tcg_graph``, replayed
    as its CUDA graph ("graph");
  * par_grid10k's f32 tiled round (``drivers.parallel_pgo.run``, 8
    agents, rank 5, 30 rounds; ms per round from the driver's clock);
  * grid10k's uncertified solve (``solvers.solve_pgo`` on the card: the
    chordal init, the f32 and f64 tile phases and the f64 edge finish;
    host seconds, the second of two runs);
  * in the first two turns only (other, then this; ``--no-gnc`` skips
    it), the centralized GNC on gnc2500 (``tools.robust_bench.central``):
    its wall, stages and seconds per stage.

Prints one JSON object per turn, then one line that compares the turns'
hashes (with ``digest``: one SHA-256 over the first turn's), and, with
``--out``, writes the turns there.  Exits 1 if a turn failed or the
hashes differ.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ("other", "this", "this", "other")
TCG_ITERS = 100
SEED = 14
RANK = 5
# g2o100k's layout (generate_large_scale_g2o: 97,336 poses, kpad 389,376)
G2O100K = dict(d=3, n=97_336, l=0, b=0, T=128, nt=3_042)


def _common():
    spec = importlib.util.spec_from_file_location(
        "flat_ab_common",
        os.path.join(HERE, "dcora_tpu_torch", "tools", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tcg(common, torch, rtr, tiled, TP, rank, gen):
    """ms per iteration of a 100-iteration flat tCG solve, eager and (where
    the tree has it) through the flat CUDA graph."""
    X0 = torch.randn((8, TP.meta.kpad), generator=gen, dtype=torch.float64,
                     device="cuda")
    X0[rank:] = 0.0
    # the polar factor in f64: a nearly singular 3 x 3 block has none in f32
    Xf = tiled.retract_flat(TP.meta, torch.zeros_like(X0), X0).to(
        TP.dtype).contiguous()
    grad = rtr.FLAT_BACKEND.tangent(TP, Xf, tiled.egrad_flat(TP, Xf))
    radius = torch.tensor(1e8, dtype=TP.dtype, device="cuda")
    zero = torch.zeros_like(Xf)
    solve = functools.partial(rtr.truncated_cg, TP, Xf, grad, zero, None,
                              radius, TCG_ITERS, 1e-12, 1.0,
                              be=rtr.FLAT_BACKEND)
    fns = {"eager": solve}
    if hasattr(rtr, "tcg_graph"):
        fns["graph"] = functools.partial(
            solve, graph=rtr.TCGGraph(rtr.FLAT_BACKEND, TP, None, TCG_ITERS))
    out = {}
    for name, fn in fns.items():
        iters = int(fn().inner_iters)
        if iters != TCG_ITERS:
            raise RuntimeError(f"the {name} solve stopped after {iters}")
    ms = common.time_turns_ms(list(fns.values()), n=1)
    for name, t in zip(fns, ms):
        out[name] = t / TCG_ITERS
    return out


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _kernels(common, torch, tiled, layouts):
    """{key: SHA-256} of every kernel mode's output and of its inputs, and
    {key: device ms} of flat_rhess and flat_precond, on each (meta, agents)
    layout in f32 and f64 at r_pad 8 and 16."""
    import types

    hashes, dev = {}, {}
    for name, (meta, A) in layouts.items():
        lead = (A,) if A > 1 else ()
        for dtype in (torch.float32, torch.float64):
            for r_pad in (8, 16):
                key = f"{name} {str(dtype)[6:]} r_pad={r_pad}"
                gen = torch.Generator(device="cuda").manual_seed(SEED)

                def rand(*shape, gen=gen, dtype=dtype):
                    return torch.randn(shape, generator=gen, dtype=dtype,
                                       device="cuda")

                X, V, E = (rand(r_pad, *lead, meta.kpad) for _ in range(3))
                for a in (X, V, E):
                    a[RANK:] = 0.0
                TP = types.SimpleNamespace(
                    meta=meta, jacobi={},
                    pose_inv=rand(*lead, meta.n, meta.dh, meta.dh),
                    sph_inv=rand(*lead, meta.l), lmk_inv=rand(*lead, meta.b))
                hashes[f"{key} inputs"] = _sha(X, V, E, TP.pose_inv,
                                               TP.sph_inv, TP.lmk_inv)
                aux = tiled.weingarten_setup(meta, X, V)
                modes = {
                    "gram": lambda: tiled.weingarten_setup(meta, X, V),
                    "rhess": lambda: tiled.flat_rhess(meta, X, V, E, aux),
                    "tangent": lambda: tiled.tangent_project_flat(meta, X,
                                                                  V),
                    "hess": lambda: tiled.flat_rhess(meta, None, V, E, aux,
                                                     project=False),
                    "precond": lambda: tiled.flat_precond(TP, X, V),
                }
                for mode, fn in modes.items():
                    out = fn()
                    hashes[f"{key} {mode}"] = _sha(
                        *(out if isinstance(out, tuple) else (out,)))
                for mode in ("rhess", "precond"):
                    dev[f"{key} flat_{mode}"] = common.device_ms(modes[mode])
                del X, V, E, TP, aux, modes
    return hashes, dev


def digest(hashes: dict) -> str:
    """One SHA-256 over a turn's hashes ("key hash" lines, sorted by key)."""
    lines = "\n".join(f"{k} {v}" for k, v in sorted(hashes.items()))
    return hashlib.sha256(lines.encode()).hexdigest()


def _fleet_meta(torch, grid, A):
    """The layout of par_grid10k's stack: grid10k in A agents at rank 5,
    as drivers.parallel_pgo builds it."""
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.drivers.multi_robot_pgo import partition_measurements
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.parallel.rbcd import (build_parallel_problem,
                                               build_stacked_tiled)

    ds = read_g2o_file(grid)
    odo, priv, shared, _ = partition_measurements(
        ds.pose_pose_measurements, ds.num_poses, A)
    graphs = []
    for a in range(A):
        g = LocalGraph(a, RANK, ds.dim)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)
    pp = build_parallel_problem(graphs)
    return build_stacked_tiled(pp, 0, A, torch.float32, "cuda").meta


def turn(gnc: bool) -> dict:
    """One turn in the tree whose root is first on sys.path."""
    import torch

    import dcora_tpu_torch
    from dcora_tpu_torch.core import rtr, spmm, tiled
    from dcora_tpu_torch.drivers import parallel_pgo
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.solvers import (make_preconditioner, precond_reg,
                                         solve_pgo)

    common = _common()
    common.require_cuda("flat_ab")
    spmm.build_all()
    rec = dict(package=os.path.dirname(dcora_tpu_torch.__file__),
               platform=common.platform("cuda"), tcg={})
    gen = torch.Generator(device="cuda").manual_seed(7)
    with tempfile.TemporaryDirectory() as tmp:
        grid = common.default_grid(tmp)
        ra = common.load_graph(common.ra_set(tmp, 1950), 3)
        g = common.load_graph(grid, 5)
        P = g.problem_data(device="cuda")
        M = make_preconditioner(g, P)
        layouts = {}
        for dtype in (torch.float32, torch.float64):
            TP = tiled.build_tiled(P, g.dims, dtype=dtype, precond=M,
                                   tile_precond=False, pack="bucketed")
            layouts["grid10k"] = (TP.meta, 1)
            rec["tcg"][f"grid10k {str(dtype)[6:]}"] = _tcg(
                common, torch, rtr, tiled, TP, 5, gen)
            del TP
        Pr = ra.problem_data(device="cuda")
        TP = tiled.build_tiled(Pr, ra.dims, dtype=torch.float32,
                               precond=make_preconditioner(ra, Pr),
                               reg=precond_reg(ra, Pr), tile_precond="btd",
                               pack="bucketed")
        layouts["ra10k"] = (TP.meta, 1)
        rec["tcg"]["ra10k float32"] = _tcg(common, torch, rtr, tiled, TP, 3,
                                           gen)
        del TP, Pr, P, M
        layouts["par_grid10k"] = (_fleet_meta(torch, grid, 8), 8)
        layouts["g2o100k"] = (tiled.TiledMeta(**G2O100K), 1)
        rec["hashes"], rec["kernel_device_ms"] = _kernels(
            common, torch, tiled, layouts)
        one = torch.zeros(1, device="cuda")
        rec["fill_device_ms"] = common.device_ms(lambda: one.fill_(1.0))
        res = parallel_pgo.run(8, grid, max_rounds=30, rgrad_norm_tol=0.0,
                               check_every=1, backend="tiled",
                               tile_dtype=torch.float32, device="cuda")
        rec["par_grid10k_f32_ms_per_round"] = 1e3 * res.rounds_s / res.rounds
        ms = read_g2o_file(grid).pose_pose_measurements
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            solve_pgo(ms, device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rec["grid10k_solve_s"] = walls
        if gnc:
            from dcora_tpu_torch.tools import robust_bench

            r, _ = robust_bench.central(robust_bench.gnc_set(tmp),
                                        device="cuda")
            rec["gnc2500"] = dict(
                wall_s=r["wall_s"], stages=r["stages"],
                s_per_stage=r["wall_s"] / max(r["stages"], 1),
                rejected=len(r["rejected"]), init_s=r["init_s"],
                build_s=r["build_s"], solve_s=r["solve_s"])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-gnc", action="store_true")
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gnc", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.turn:  # a child: the tree to import is a.turn
        sys.path.insert(0, a.turn)
        rec = turn(a.gnc)
        if not rec["package"].startswith(os.path.abspath(a.turn)):
            raise SystemExit(f"imported {rec['package']}, not {a.turn}'s")
        with open(a.out, "w") as fh:
            json.dump(rec, fh)
        return 0
    if not a.other:
        ap.error("OTHER_TREE is required")
    trees = {"other": os.path.abspath(a.other), "this": HERE}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, side in enumerate(TURNS, 1):
            js = os.path.join(tmp, f"{i}_{side}.json")
            gnc = ["--gnc"] if i <= 2 and not a.no_gnc else []
            rc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn",
                 trees[side], "--out", js, *gnc], cwd=trees[side],
                env=env).returncode
            rec = dict(turn=i, side=side, tree=trees[side], rc=rc)
            if rc == 0:
                with open(js) as fh:
                    rec.update(json.load(fh))
            records.append(rec)
            print(json.dumps(rec), flush=True)
    hashes = [r.get("hashes", {}) for r in records]
    differ = sorted(k for k in set().union(*hashes)
                    if len({h.get(k) for h in hashes}) != 1)
    print(json.dumps(dict(hashes=len(hashes[0]), turns=len(hashes),
                          all_equal=not differ, differ=differ,
                          digest=digest(hashes[0]))), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0 if all(r["rc"] == 0 for r in records) and not differ else 1


if __name__ == "__main__":
    sys.exit(main())
