"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three SpMM kernel libraries from ``dcora_tpu_torch/csrc/`` (one
nvcc per source, all started together; ``-Xptxas -v``'s registers and
spills are printed) and holds every kernel against its plain PyTorch
version on the card at the 10,648-pose grid's shapes, timed in turns with
the library yardstick ``torch.sparse.mm`` on the same Q and beside the
product's bound.  Then it drives the port's paths, each with the kernels'
launch counts set to 0 just before it and read just after:

  * the certified single-robot PGO staircase of
    ``dcora_tpu_torch.drivers.single_robot_pgo.run(..., certify=True,
    device="cuda")`` on the generated smallGrid3D set (125 poses) and on the
    10,648-pose grid (``generate_large_scale_g2o(target_poses=10_000)``),
    through the owner-computes strip kernel (``csrc/spmm_sym.cu``), one
    launch per tile product;
  * the same certified 10,648-pose solve under ``DCORA_SPMM_PACK=paired``,
    through the grouped kernel (``csrc/spmm_grouped.cu``: the two-row packs
    and their single-row leftovers, compacted to their non-empty
    sub-blocks), one launch per tile product;
  * the bench entry points: ``tools.spmm_bench`` (every SpMM backend, the
    per-tile kernel ``csrc/spmm_tile.cu`` on the tile list's non-empty
    sub-blocks included) and ``tools.bench`` for both packs;
  * the certified single-robot RA-SLAM staircase of
    ``dcora_tpu_torch.drivers.single_robot_raslam.run(..., device="cuda")``
    at the driver's own budget on two generated PyFG sets
    (``tools.common.ra_set``): ``ra500`` (500 poses, 420 ranges) and
    ``ra10k`` (9,750 poses, 7,820 ranges, the size of the reference's
    tiers.pyfg), through the strip kernel on the range-aided tiles, one
    launch per tile product, with the block-tridiagonal preconditioner and
    the edge path's tCG iterations replayed as CUDA graphs.  The result is
    held to certification, the independent LDL^T witness, the independent
    verifier's cost and, where tests/data/torch_port_ra_reference.json
    has the set, the JAX package's f*.

Before the RA solves the kernel phase also holds the strip kernel against
its plain version on the ra10k Q, beside ``torch.sparse.mm`` and the bound;
the BTD phase holds the preconditioner's CUDA graph against its plain loop
there, and the tCG phase the edge path's tCG graph against its iterations
issued one by one, and times one application or iteration of each.

Sequential and fail-closed: every phase prints a line and any failure
raises, so the exit code is non-zero and the result line is not printed.
Imports nothing of JAX.  The last line of standard output is one JSON
object: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(HERE, "tests", "data",
                         "torch_port_pgo_reference.json")
RA_REFERENCE = os.path.join(HERE, "tests", "data",
                            "torch_port_ra_reference.json")
# name -> (poses per robot, r_max).  ra500 climbs the whole staircase.
# ra10k runs its first rank only: at the driver's budget each of its ranks
# takes 2-3 min on the card and the staircase climbed past rank 7
# uncertified (PERF.md), beyond this script's time; its rank-3 solve and
# certificate are held to the independent verifier instead
RA_SETS = {"ra500": (100, 20), "ra10k": (1950, 3)}
KERNELS = {
    "spmm_sym": dict(name="spmm_sym", route="cuda",
                     source="dcora_tpu_torch/csrc/spmm_sym.cu",
                     replaces="dcora_tpu/core/pallas_spmm.py:307"),
    "spmm_tile": dict(name="spmm_tile", route="cuda",
                      source="dcora_tpu_torch/csrc/spmm_tile.cu",
                      replaces="dcora_tpu/core/pallas_spmm.py:37"),
    "spmm_paired": dict(name="spmm_paired", route="cuda",
                        source="dcora_tpu_torch/csrc/spmm_grouped.cu",
                        replaces="dcora_tpu/core/pallas_spmm.py:515"),
}
LIBRARY = "library"  # torch.sparse.mm on the full symmetric Q, CSR
# relative to max|W|: a different summation order, plus f32 rounding
TOL = {"float32": 1e-5, "float64": 1e-12}
F_RTOL = 1e-8  # certified f* against the JAX reference values
# RA: f* against the JAX reference; the JAX package's edge and tiled paths
# certify ra500 1.3e-7 apart (the slack of gradnorm_tol 1e-4)
RA_F_RTOL = 1e-6
RA_ETA = 1e-4  # the RA driver's certificate tolerance and the witness's
# the BTD graph against its plain loop, relative to max|Y|
BTD_TOL = {"float32": 1e-4, "float64": 1e-10}
# the tCG graph against its iterations issued one by one, relative to
# max|eta| (index_add_ sums in another order from call to call)
TCG_TOL = 1e-9


def phase(msg: str):
    print(msg, flush=True)


def require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def device_phase(torch):
    require(torch.cuda.is_available(),
            "torch.cuda.is_available() is false; this script runs only on "
            "a CUDA device")
    from dcora_tpu_torch.tools.common import card

    name = torch.cuda.get_device_name(0)
    phase(f"[device] {name}; torch {torch.__version__}; CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    power = card()
    print(power, flush=True)
    return name, power


def ptxas_lines(log: str):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    entry function in an ``nvcc -Xptxas -v`` log."""
    out, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1))) + spill)
            fn, spill = None, (0, 0)
    return out


def build_phase(spmm):
    t0 = time.perf_counter()
    libs = spmm.build_all()
    phase(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.2f}s"
          " (one nvcc per source, in parallel): " + ", ".join(
              f"{os.path.basename(lib.path())} (nvcc "
              f"{lib.build_seconds or 0.0:.2f}s)" for lib in libs.values()))
    for name, lib in libs.items():
        for fn, regs, st, ld in ptxas_lines(lib.build_log):
            phase(f"[ptxas] {name} (B={spmm.BLOCK}) {fn}: {regs} registers, "
                  f"spill stores {st} B, spill loads {ld} B")
            require(st == 0 and ld == 0, f"{fn} spills registers")


def compare_and_time(torch, problem, cases, library, dense, X, live,
                     bound):
    """Hold each kernel of `cases` (name -> (kernel, plain version)) and the
    library call against its plain version and the dense-tile reference on
    the same X, then time them all in turns; one row per kernel."""
    from dcora_tpu_torch.tools import common

    dt = str(X.dtype).split(".")[-1]
    r_pad = X.shape[0]
    errs = {}
    for name, (kern, plain) in [*cases.items(),
                                (LIBRARY, (lambda: library().t(), None))]:
        W = kern()
        Wp = plain() if plain else dense
        torch.cuda.synchronize()
        require(bool(torch.isfinite(W).all()), f"{name} output not finite")
        scale = float(dense.abs().max())
        abs_err = max(float((W - Wp).abs().max()),
                      float((W - dense).abs().max()))
        require(abs_err <= TOL[dt] * scale,
                f"{name} disagrees with plain ({problem}, {dt}, r_pad "
                f"{r_pad}, live {live}): {abs_err:.3e} > {TOL[dt]:.0e} * "
                f"{scale:.3e}")
        require(not W[live:].any(), f"{name}: zero rows not zero")
        errs[name] = (abs_err, abs_err / scale)
    ms = common.time_turns_ms(
        [f for pair in cases.values() for f in pair] + [library])
    rows = []
    for i, name in enumerate(cases):
        rows.append(dict(kernel=name, problem=problem, dtype=dt, r_pad=r_pad,
                         live=live, max_abs_err=errs[name][0],
                         ms=ms[2 * i], plain_ms=ms[2 * i + 1],
                         library_ms=ms[-1], bound_ms=bound[0],
                         bound_by=bound[1]))
        phase(f"[kernel] {name} {problem} {dt} r_pad={r_pad} live_rows={live} "
              f"max_abs_err={errs[name][0]:.3e} (rel {errs[name][1]:.2e}) "
              f"kernel_ms={ms[2 * i]:.4f} plain_ms={ms[2 * i + 1]:.4f} "
              f"library_ms={ms[-1]:.4f} (rel err {errs[LIBRARY][1]:.2e}) "
              f"bound_ms={bound[0]:.4f} ({bound[1]}) (per launch, "
              f"{common.LAUNCHES} back to back, median of 3 turns)")
    return rows


def hbm_gbs(torch):
    from dcora_tpu_torch.tools import common

    return common.nominal_hbm_gbs(torch.cuda.get_device_name(0)) or \
        common.NOMINAL_HBM_GBS[0][1]


def kernel_phase(torch, path10k):
    """Every kernel against its plain version on the card, at the main
    paths' shapes: r_pad 8 and 16 in f32 and f64, and r_pad 8 with one live
    row (the tiled Lanczos operand).  Kernel 1 (spmm_sym) on the strip CSR
    of the default build, kernel 2 (spmm_tile) on the per-tile list padded
    to 8-tile chunks and compacted to its non-empty sub-blocks (no dense
    tile reaches the card's kernel), kernel 3 (spmm_grouped.cu) on the
    paired pack's compacted sub-blocks (two-row groups and single-row
    leftovers in one launch), as apply_tiled runs them.  All timed in turns
    on the same X with the library call torch.sparse.mm(Q_csr, X^T) (X^T
    made outside the timed call); each row carries the product's bound."""
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.solvers import make_preconditioner
    from dcora_tpu_torch.tools import common
    from dcora_tpu_torch.tools.spmm_bench import tile_blocks

    ds = read_g2o_file(path10k)
    g = LocalGraph(0, 5, 3)
    g.set_measurements(ds.pose_pose_measurements)
    P = g.problem_data(device="cuda")
    M = make_preconditioner(g, P)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        TP = tiled.build_tiled(P, g.dims, dtype=dtype, precond=M,
                               pack="paired")
        Q, kpad = TP.Q, TP.meta.kpad
        tb = tile_blocks(Q)
        nblk = int(spmm.nonempty_blocks(Q.tiles.cpu().numpy()).sum())
        require(tb.vals.numel() == spmm.BLOCK ** 2 * nblk,
                f"kernel 2's layout holds {tb.vals.numel()} values, not the "
                f"{nblk} non-empty blocks' {spmm.BLOCK ** 2 * nblk}")
        csr, stored_nnz = common.symmetric_csr(Q, kpad)
        masked = (Q.pairs.run_col & 1).bool()
        require(bool(masked.any()) and not bool(masked.all()),
                "the paired pack has no masked or no unmasked run")
        for r_pad, live in ((8, 8), (16, 16), (8, 1)):
            X = torch.zeros((r_pad, kpad), dtype=dtype, device="cuda")
            X[:live] = torch.randn((live, kpad), generator=gen,
                                   dtype=dtype, device="cuda")
            Xt = X.t().contiguous()
            cases = {
                "spmm_sym": (
                    lambda: spmm.spmm_sym(Q.strips, X),
                    lambda: spmm.spmm_strips_plain(Q.strips, X)),
                "spmm_tile": (
                    lambda: spmm.spmm_symmetric(tb, X),
                    lambda: spmm.spmm_symmetric_plain(tb, X)),
                "spmm_paired": (
                    lambda: spmm.spmm_paired(Q.pairs, X),
                    lambda: spmm.spmm_paired_plain(Q.pairs, X)),
            }
            dense = spmm.spmm_sym_plain(Q.tiles, Q.tile_rows, Q.tile_cols, X)
            bound = common.spmm_bound_ms(stored_nnz, csr.values().numel(),
                                         r_pad, kpad, dtype, hbm_gbs(torch))
            rows += compare_and_time(
                torch, "grid10k", cases,
                lambda: torch.sparse.mm(csr, Xt),  # noqa: B023
                dense, X, live, bound)
    return rows


def ra_kernel_phase(torch, path):
    """Kernel 1 (spmm_sym) on the range-aided tiles of the ra10k Q, as the
    RA solve builds them (BTD preconditioner), against its plain version,
    torch.sparse.mm and the bound, at f32/f64 x r_pad 8/16.  Returns the
    rows and the two TiledProblems (for the BTD phase)."""
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.solvers import make_preconditioner, precond_reg
    from dcora_tpu_torch.tools import common

    g = common.load_graph(path, 3)
    P = g.problem_data(device="cuda")
    M, reg = make_preconditioner(g, P), precond_reg(g, P)
    rows, tps = [], {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        TP = tiled.build_tiled(P, g.dims, dtype=dtype, precond=M, reg=reg,
                               tile_precond="btd", pack="bucketed")
        build_s = time.perf_counter() - t0
        Q, kpad = TP.Q, TP.meta.kpad
        tps[dtype] = TP
        csr, stored_nnz = common.symmetric_csr(Q, kpad)
        phase(f"[ra tiles] ra10k {str(dtype).split('.')[-1]}: n={g.n} "
              f"l={g.l} b={g.b} {common.q_stats(TP)} ({spmm.BLOCK}x"
              f"{spmm.BLOCK} blocks), host build with the BTD factor "
              f"{build_s:.2f}s")
        for r_pad in (8, 16):
            X = torch.randn((r_pad, kpad), generator=gen, dtype=dtype,
                            device="cuda")
            Xt = X.t().contiguous()
            cases = {"spmm_sym": (
                lambda: spmm.spmm_sym(Q.strips, X),
                lambda: spmm.spmm_strips_plain(Q.strips, X))}
            dense = spmm.spmm_sym_plain(Q.tiles, Q.tile_rows, Q.tile_cols, X)
            bound = common.spmm_bound_ms(stored_nnz, csr.values().numel(),
                                         r_pad, kpad, dtype, hbm_gbs(torch))
            rows += compare_and_time(
                torch, "ra10k", cases,
                lambda: torch.sparse.mm(csr, Xt),  # noqa: B023
                dense, X, r_pad, bound)
    return rows, tps


def btd_phase(torch, tps):
    """The BTD preconditioner on the ra10k tiles: its CUDA graph against the
    plain loop on the card (the CPU path), and one application of each
    timed in turns, at f32/f64 x r_pad 8/16."""
    from dcora_tpu_torch.core import tiled
    from dcora_tpu_torch.tools import common

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype, TP in tps.items():
        dt = str(dtype).split(".")[-1]
        for r_pad in (8, 16):
            V = torch.randn((r_pad, TP.meta.kpad), generator=gen, dtype=dtype,
                            device="cuda")
            t0 = time.perf_counter()
            Y = tiled.precondition_flat(TP, V)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            Yp = tiled._precondition_btd(TP, V)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(Y).all()), "BTD graph not finite")
            rel = float((Y - Yp).abs().max()) / float(Yp.abs().max())
            require(rel <= BTD_TOL[dt], f"BTD graph disagrees with the loop "
                    f"({dt}, r_pad {r_pad}): rel {rel:.3e}")
            graph_ms, plain_ms = common.time_turns_ms(
                [lambda: tiled.precondition_flat(TP, V),  # noqa: B023
                 lambda: tiled._precondition_btd(TP, V)], n=10)  # noqa: B023
            bound = common.btd_bound_ms(TP.meta.nt, TP.meta.T, r_pad, dtype,
                                        hbm_gbs(torch))
            out[(dt, r_pad)] = graph_ms
            phase(f"[btd] ra10k {dt} r_pad={r_pad} nt={TP.meta.nt}: graph "
                  f"{graph_ms:.4f} ms, plain loop {plain_ms:.4f} ms per "
                  f"application (CUDA events, 10 back to back, median of 3 "
                  f"turns), bound {bound[0]:.4f} ms ({bound[1]}), rel err "
                  f"{rel:.2e}, capture {capture_s:.2f}s")
    return out


def counting_products(tiled):
    """Wrap tiled.apply_tiled (every tile product of the solve goes through
    it) to count products; returns (count holder, restore)."""
    real, n = tiled.apply_tiled, [0]

    def counted(TP, X):
        n[0] += 1
        return real(TP, X)

    tiled.apply_tiled = counted
    return n, lambda: setattr(tiled, "apply_tiled", real)


def slice_phase(torch, name, path, ref):
    """The certified staircase on the card, held to the JAX reference."""
    import numpy as np

    from dcora_tpu_torch.drivers.single_robot_pgo import run
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.verification import verify_solution

    res = {}
    t0 = time.perf_counter()
    T, f = run(path, certify=True, device="cuda", verbose=False, result=res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = res["staircase"]
    require(st.X.rot.is_cuda and st.rounded.rot.is_cuda,
            f"{name}: state tensors are not on CUDA")
    require(T.shape == (ref["n"], 3, 4) and bool(np.isfinite(T).all()),
            f"{name}: bad trajectory shape or values")
    require(st.certified, f"{name}: not certified")
    require(st.final_rank == ref["rank"],
            f"{name}: rank {st.final_rank} != reference {ref['rank']}")
    rel = abs(f - ref["f"]) / abs(ref["f"])
    require(rel <= F_RTOL, f"{name}: f* {f!r} vs reference {ref['f']!r} "
            f"(rel {rel:.2e} > {F_RTOL:.0e})")
    t1 = time.perf_counter()
    rep = verify_solution(read_g2o_file(path).pose_pose_measurements, st.X,
                          3, eta=1e-3)
    require(rep["certified_indep"] is True,
            f"{name}: the LDL^T verifier does not witness S + eta I >= 0")
    stages = " ".join(f"{k}={v:.2f}s" for k, v in st.stage_seconds.items())
    phase(f"[slice] {name}: n={ref['n']} certified={st.certified} "
          f"rank={st.final_rank} f*={f!r} (reference {ref['f']!r}, rel "
          f"{rel:.1e}) ldl_witness=True wall={wall:.2f}s "
          f"(init {res['init_s']:.2f}s, staircase "
          f"{res['staircase_s']:.2f}s: {stages}) "
          f"verify={time.perf_counter() - t1:.2f}s")
    return wall


def paired_phase(torch, path, ref):
    """The certified 10,648-pose solve under DCORA_SPMM_PACK=paired: every
    tile product of the f32 and f64 phases and of the tiled Lanczos runs on
    the compacted paired packs, one launch each."""
    from dcora_tpu_torch.core import spmm, tiled

    old = os.environ.get("DCORA_SPMM_PACK")
    os.environ["DCORA_SPMM_PACK"] = "paired"
    products, restore = counting_products(tiled)
    try:
        spmm.reset_launches()
        wall = slice_phase(torch, "grid10k paired pack", path, ref)
        counts = spmm.launch_counts()
    finally:
        restore()
        if old is None:
            del os.environ["DCORA_SPMM_PACK"]
        else:
            os.environ["DCORA_SPMM_PACK"] = old
    require(counts["spmm_paired"] == products[0] > 0,
            f"the paired solve did not launch the grouped kernel once per "
            f"tile product: {counts}, {products[0]} products")
    require(counts["spmm_sym"] == 0 and counts["spmm_symmetric"] == 0,
            f"the paired solve launched another SpMM kernel: {counts}")
    phase(f"[launches] paired solve: {counts}, {products[0]} tile products "
          f"(wall {wall:.2f}s)")
    return counts


def bench_phase(torch, path):
    """The bench entry points in process: spmm_bench (the path of the
    per-tile kernel), then tools.bench for both packs."""
    from dcora_tpu_torch.core import spmm
    from dcora_tpu_torch.tools import bench, spmm_bench

    spmm.reset_launches()
    res = spmm_bench.run(path)
    counts = spmm.launch_counts()
    require(counts["spmm_symmetric"] > 0,
            f"spmm_bench never launched the per-tile kernel: {counts}")
    require(max(r["rel_err"] for r in res["rows"]) <= TOL["float32"],
            "an spmm_bench row disagrees with the plain tile path")
    phase(f"[launches] spmm_bench: {counts}")
    for pack in ("bucketed", "paired"):
        out = bench.run(path, pack=pack)
        require(out["value"] > 0, f"bench ({pack}) measured nothing")
        print(json.dumps(out), flush=True)
    return counts


def tcg_phase(torch, path):
    """The edge path's tCG on the ra10k problem at rank 3, at the odometry
    init: its CUDA graph (core/rtr.TCGGraph) against the iterations issued
    one by one on the same inputs, over at most 6 iterations (CG carries
    the atomics' rounding differences along, so longer solves drift apart);
    then one 200-iteration solve of each, timed in turns.  The timed
    solves take the Hessian without its Weingarten term (a zero Euclidean
    gradient), which is positive semidefinite on the tangent space, so
    neither stops before its 200 iterations; they run the same kernels.
    Returns ms per iteration through the graph and the loop."""
    from dcora_tpu_torch.core import rtr
    from dcora_tpu_torch.drivers.single_robot_raslam import (
        odometry_init_global)
    from dcora_tpu_torch.io import read_pyfg_file
    from dcora_tpu_torch.io.remap import get_global_measurements
    from dcora_tpu_torch.solvers import make_preconditioner
    from dcora_tpu_torch.tools import common

    ds = read_pyfg_file(path)
    gm = get_global_measurements(ds)
    g = common.load_graph(path, 3)
    P = g.problem_data(device="cuda")
    M = make_preconditioner(g, P)
    X = odometry_init_global(ds, gm).to("cuda")
    egrad = rtr.RA_BACKEND.applyQ(P, X)
    grad = rtr.RA_BACKEND.tangent(P, X, egrad)
    flat = rtr.tmap(torch.zeros_like, egrad)
    radius = torch.tensor(1e8, dtype=torch.float64, device="cuda")
    short = rtr.TCGGraph(rtr.RA_BACKEND, P, M, 6)
    graph = rtr.TCGGraph(rtr.RA_BACKEND, P, M, 200)

    def solve(gr, eg=flat, n=200):
        return rtr.truncated_cg(P, X, grad, eg, M, radius, n, 1e-12, 1.0,
                                graph=gr)

    res_g, res_l = solve(short, egrad, 6), solve(None, egrad, 6)
    steps = int(res_g.inner_iters)
    require(steps == int(res_l.inner_iters) > 0,
            f"tCG graph ran {steps} iterations, the loop "
            f"{int(res_l.inner_iters)}")
    rel = max(float((a - b).abs().max()) / float(b.abs().max())
              for x, y in ((res_g.eta, res_l.eta), (res_g.Heta, res_l.Heta))
              for a, b in zip(x, y) if b.numel() and b.abs().max() > 0)
    require(rel <= TCG_TOL, f"tCG graph disagrees with the loop over "
            f"{steps} iterations: rel {rel:.3e}")
    t0 = time.perf_counter()
    full = int(solve(graph).inner_iters)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    require(full == int(solve(None).inner_iters) == 200,
            f"the timed tCG solves stopped early: {full} iterations")
    graph_ms, loop_ms = common.time_turns_ms(
        [lambda: solve(graph), lambda: solve(None)], n=1)
    phase(f"[tcg] ra10k edge path r=3: graph {graph_ms / full:.4f} ms, "
          f"loop {loop_ms / full:.4f} ms per iteration ({full} iterations "
          f"per solve, CUDA events, median of 3 turns); over {steps} "
          f"iterations with the Weingarten term graph vs loop rel err "
          f"{rel:.2e}; first 200-iteration solve with capture "
          f"{capture_s:.2f}s")
    return graph_ms / full, loop_ms / full


def raslam_phase(torch, name, path, ref, r_max):
    """The RA-SLAM staircase on the card through the driver, at full size
    and the driver's own budget (200 RTR iterations, 200 tCG iterations,
    eta 1e-4) up to rank r_max.  At the result, the independent verifier
    (scipy, verification.verify_solution) must give the same lifted cost,
    the same Riemannian gradient norm and the same verdict as the port's
    certificate, and the cost must lie below the initial estimate's.  At
    r_max 20 (the driver's default) the result must certify, so the
    verifier's LDL^T witness of S + eta I >= 0 must hold, and its f* (the
    rounded and refined cost, as for PGO) must be the JAX package's where
    tests/data/torch_port_ra_reference.json has the set.  Every tile
    product must launch kernel 1 once, and no other SpMM kernel may run.
    Returns (launch counts, wall)."""
    import numpy as np

    from dcora_tpu_torch.core import lifted, problem as prob
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.core.manifold import manifold_error
    from dcora_tpu_torch.drivers.single_robot_raslam import (
        odometry_init_global, run)
    from dcora_tpu_torch.io import read_pyfg_file
    from dcora_tpu_torch.verification import (
        sparse_Q_ra, split_measurements, verify_solution)

    btd, real_btd = {}, tiled.precondition_btd_graph

    def counted_btd(TP, Vf):
        key = f"{str(Vf.dtype).split('.')[-1]}/{Vf.shape[0]}"
        btd[key] = btd.get(key, 0) + 1
        return real_btd(TP, Vf)

    res = {}
    products, restore = counting_products(tiled)
    tiled.precondition_btd_graph = counted_btd
    try:
        spmm.reset_launches()
        t0 = time.perf_counter()
        st, g, gm = run(path, r_max=r_max, device="cuda", verbose=False,
                        result=res)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = spmm.launch_counts()
    finally:
        restore()
        tiled.precondition_btd_graph = real_btd
    require(st.X.rot.is_cuda and st.rounded.sph.is_cuda,
            f"{name}: state tensors are not on CUDA")
    require(st.rounded.rot.shape == (g.n, 3, 3)
            and st.rounded.sph.shape == (g.l, 3)
            and st.rounded.trn.shape == (g.n + g.b, 3)
            and all(bool(torch.isfinite(x).all()) for x in st.rounded)
            and all(bool(torch.isfinite(x).all()) for x in st.X),
            f"{name}: bad state shape or values")
    require(float(manifold_error(st.X)) < 1e-10
            and float(manifold_error(st.rounded)) < 1e-10,
            f"{name}: the result is off the manifold")
    require(counts["spmm_sym"] == products[0] > 0,
            f"{name}: the strip kernel did not run once per tile product: "
            f"{counts}, {products[0]} products")
    require(counts["spmm_paired"] == 0 and counts["spmm_symmetric"] == 0,
            f"{name}: the RA solve launched another SpMM kernel: {counts}")
    t1 = time.perf_counter()
    rep = verify_solution(gm.relative_measurements, st.X, 3, eta=RA_ETA)
    verify_s = time.perf_counter() - t1
    # the verifier sums 0.5 <X Q, X> over Q's entries, whose terms grow
    # with the squared coordinates and cancel down to f: its rounding
    # error scales with 0.5 <|X| |Q|, |X|>, not with f (4.8e-7 of f on
    # ra10k's rank-3 iterate on the card); 1e-12 of it lies below the
    # worst case for ~1e5 terms per sum (1e5 * 2.2e-16)
    Q = sparse_Q_ra(*split_measurements(gm.relative_measurements), g.n, g.l,
                    g.b, 3)
    Xa = np.abs(lifted.to_flat(st.X).cpu().numpy())
    f_scale = 0.5 * float(np.sum((Xa @ abs(Q)) * Xa))
    f_tol = 1e-9 * abs(rep["f_indep"]) + 1e-12 * f_scale
    rel_f = abs(rep["f_indep"] - st.f_final) / abs(rep["f_indep"])
    # relative above 1, absolute below: both sum the gradient's terms in
    # f64, in another order, so small norms agree only to rounding
    rel_gn = abs(rep["gradnorm_indep"] - st.gradnorm_final) / \
        max(rep["gradnorm_indep"], 1.0)
    f, f_lifted = res["f_rounded"], st.f_final
    f_init = float(prob.cost(
        g.problem_data(device="cuda"),
        odometry_init_global(read_pyfg_file(path), gm).to("cuda")))
    stages = " ".join(f"{k}={v:.2f}s" for k, v in st.stage_seconds.items())
    phase(f"[raslam] {name}: n={g.n} l={g.l} b={g.b} r_max={r_max} "
          f"certified={st.certified} rank={st.final_rank} f*={f!r} lifted "
          f"f={f_lifted!r} (init {f_init!r}) gradnorm="
          f"{st.gradnorm_final:.3e} min_eig_history={st.min_eig_history} "
          f"ldl_witness={rep['certified_indep']} verifier: gradnorm "
          f"{rep['gradnorm_indep']:.3e} (rel {rel_gn:.1e}), min eig "
          f"{rep['min_eig_indep']:.3e}, f rel {rel_f:.1e} (tolerance "
          f"{f_tol / abs(rep['f_indep']):.1e}, 0.5<|X||Q|,|X|> "
          f"{f_scale:.3e}); "
          f"wall={wall:.2f}s (read {res['read_s']:.2f}s, init "
          f"{res['init_s']:.2f}s, staircase {res['staircase_s']:.2f}s: "
          f"{stages}) verify={verify_s:.2f}s; tile products {products[0]}, "
          f"launches {counts}; BTD applications {btd}")
    require(abs(rep["f_indep"] - f_lifted) <= f_tol, f"{name}: the lifted "
            f"cost {f_lifted!r} is not the independent verifier's "
            f"{rep['f_indep']!r}")
    require(rel_gn <= 1e-6, f"{name}: the gradient norm "
            f"{st.gradnorm_final!r} is not the verifier's "
            f"{rep['gradnorm_indep']!r}")
    require(bool(rep["certified_indep"]) == bool(st.certified),
            f"{name}: the port's "
            f"certificate says {st.certified}, the LDL^T verifier "
            f"{rep['certified_indep']}")
    require(f_lifted < f_init, f"{name}: the cost did not fall below the "
            f"initial estimate's ({f_lifted!r} >= {f_init!r})")
    if not st.certified:
        require(r_max < 20 and st.final_rank == r_max
                and st.min_eig_history[-1] < -RA_ETA,
                f"{name}: not certified (rank {st.final_rank})")
    if ref is not None and ref["certified"]:
        require(ref["n"] == g.n and ref["l"] == g.l,
                f"{name}: the reference is for another set")
        rel = abs(f - ref["f"]) / abs(ref["f"])
        rel_l = abs(f_lifted - ref["f_lifted"]) / abs(ref["f_lifted"])
        phase(f"[raslam] {name}: reference rank {ref['rank']} "
              f"f*={ref['f']!r}, rel {rel:.1e}; lifted {ref['f_lifted']!r} "
              f"at gradnorm {ref['gradnorm']:.3e}, rel {rel_l:.1e}")
        require(rel <= RA_F_RTOL, f"{name}: f* {f!r} vs reference "
                f"{ref['f']!r} (rel {rel:.2e} > {RA_F_RTOL:.0e})")
    return counts, wall


def main() -> int:
    require(os.path.isdir(os.path.join(HERE, "dcora_tpu_torch")),
            "dcora_tpu_torch/ is not beside this script: run it from a "
            "checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    kind, _ = device_phase(torch)
    t_start = time.perf_counter()

    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.tools import common

    build_phase(spmm)

    with open(REFERENCE) as fh:
        refs = json.load(fh)
    ra_refs = {}
    if os.path.exists(RA_REFERENCE):
        with open(RA_REFERENCE) as fh:
            ra_refs = json.load(fh)
    rows, counts, paired, benched, ra = [], {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name in ("smallGrid3D", "grid10k"):
            kw = dict(refs[name]["kwargs"])
            if "shape" in kw:
                kw["shape"] = tuple(kw["shape"])
            paths[name] = getattr(datasets, refs[name]["generator"])(
                os.path.join(tmp, name + ".g2o"), **kw)
        for name, (per_robot, _) in RA_SETS.items():
            paths[name] = common.ra_set(tmp, per_robot)
            if name in ra_refs:
                require(ra_refs[name]["kwargs"] == dict(
                    common.RA_KW, poses_per_robot=per_robot),
                    f"{name}: the reference was made from another set")
        phase("[data] generated " + ", ".join(
            f"{k} ({refs[k]['n']} poses, {refs[k]['m']} edges)"
            for k in ("smallGrid3D", "grid10k")) + "; " + ", ".join(
            f"{k} (PyFG, {5 * v} poses, tools.common.ra_set, reference "
            f"{'recorded' if k in ra_refs else 'absent'})"
            for k, (v, _) in RA_SETS.items()))

        rows = kernel_phase(torch, paths["grid10k"])
        os.environ.pop("DCORA_SPMM_PACK", None)  # the default strip pack
        products, restore = counting_products(tiled)
        try:
            spmm.reset_launches()
            walls = {name: slice_phase(torch, name, paths[name],
                                       refs[name])
                     for name in ("smallGrid3D", "grid10k")}
            counts = spmm.launch_counts()
        finally:
            restore()
        require(counts["spmm_sym"] == products[0] > 0,
                f"the main path did not launch the strip kernel once per "
                f"tile product: {counts}, {products[0]} products")
        require(counts["spmm_paired"] == 0
                and counts["spmm_symmetric"] == 0,
                f"the default solve launched another SpMM kernel: "
                f"{counts}")
        phase(f"[launches] default pack: {counts}, {products[0]} tile "
              f"products (10,648-pose grid wall {walls['grid10k']:.2f}s)")
        paired = paired_phase(torch, paths["grid10k"], refs["grid10k"])
        benched = bench_phase(torch, paths["grid10k"])
        ra_rows, tps = ra_kernel_phase(torch, paths["ra10k"])
        rows += ra_rows
        btd_phase(torch, tps)
        del tps
        tcg_phase(torch, paths["ra10k"])
        os.environ.pop("DCORA_SPMM_PACK", None)
        for name, (_, r_max) in RA_SETS.items():
            ra[name] = raslam_phase(torch, name, paths[name],
                                    ra_refs.get(name), r_max)
            phase(f"[launches] {name}: {ra[name][0]} (wall "
                  f"{ra[name][1]:.2f}s)")

    elapsed = time.perf_counter() - t_start
    # the row each kernel's path launches most: f64 at r_pad 8 on the grid
    # for the certified solves (the f64-tile phase's tCG product), f32 at
    # r_pad 8 for spmm_bench; kernel 1's launches are those of the PGO and
    # the RA solves together
    launches = dict(spmm_sym=counts["spmm_sym"] + sum(
                        c["spmm_sym"] for c, _ in ra.values()),
                    spmm_tile=benched["spmm_symmetric"],
                    spmm_paired=paired["spmm_paired"])
    phase("[launches] spmm_sym per path: " + ", ".join(
        [f"pgo {counts['spmm_sym']}"]
        + [f"{k} {c['spmm_sym']}" for k, (c, _) in ra.items()]))
    main_dtype = dict(spmm_sym="float64", spmm_tile="float32",
                      spmm_paired="float64")
    entries = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        main_row = next(r for r in mine if r["dtype"] == main_dtype[name]
                        and r["r_pad"] == 8 and r["live"] == 8
                        and r["problem"] == "grid10k")
        entries.append(dict(meta, launches=launches[name],
                            max_abs_err=max(r["max_abs_err"] for r in mine),
                            **{k: main_row[k] for k in (
                                "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}))
    phase(f"[done] {elapsed:.1f}s after the device check")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
