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
    sub-blocks included) and ``tools.bench`` for both packs.

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
    gbs = common.nominal_hbm_gbs(torch.cuda.get_device_name(0)) or \
        common.NOMINAL_HBM_GBS[0][1]
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
            library = lambda: torch.sparse.mm(csr, Xt)  # noqa: E731
            dt = str(dtype).split(".")[-1]
            dense = spmm.spmm_sym_plain(Q.tiles, Q.tile_rows, Q.tile_cols, X)
            errs = {}
            for name, (kern, plain) in [*cases.items(),
                                        (LIBRARY, (lambda: library().t(),
                                                   None))]:
                W = kern()
                Wp = plain() if plain else dense
                torch.cuda.synchronize()
                require(bool(torch.isfinite(W).all()),
                        f"{name} output not finite")
                scale = float(dense.abs().max())
                abs_err = max(float((W - Wp).abs().max()),
                              float((W - dense).abs().max()))
                require(abs_err <= TOL[dt] * scale,
                        f"{name} disagrees with plain ({dt}, r_pad {r_pad}, "
                        f"live {live}): {abs_err:.3e} > {TOL[dt]:.0e} * "
                        f"{scale:.3e}")
                require(not W[live:].any(), f"{name}: zero rows not zero")
                errs[name] = (abs_err, abs_err / scale)
            ms = common.time_turns_ms(
                [f for pair in cases.values() for f in pair] + [library])
            bound, by = common.spmm_bound_ms(stored_nnz, csr.values().numel(),
                                             r_pad, kpad, dtype, gbs)
            for i, name in enumerate(cases):
                rows.append(dict(kernel=name, dtype=dt, r_pad=r_pad,
                                 live=live, max_abs_err=errs[name][0],
                                 ms=ms[2 * i], plain_ms=ms[2 * i + 1],
                                 library_ms=ms[-1], bound_ms=bound,
                                 bound_by=by))
                phase(f"[kernel] {name} {dt} r_pad={r_pad} live_rows={live} "
                      f"max_abs_err={errs[name][0]:.3e} (rel "
                      f"{errs[name][1]:.2e}) kernel_ms={ms[2 * i]:.4f} "
                      f"plain_ms={ms[2 * i + 1]:.4f} "
                      f"library_ms={ms[-1]:.4f} (rel err "
                      f"{errs[LIBRARY][1]:.2e}) bound_ms={bound:.4f} ({by}) "
                      f"(per launch, {common.LAUNCHES} back to back, median "
                      f"of 3 turns)")
    return rows


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

    build_phase(spmm)

    with open(REFERENCE) as fh:
        refs = json.load(fh)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name in ("smallGrid3D", "grid10k"):
            kw = dict(refs[name]["kwargs"])
            if "shape" in kw:
                kw["shape"] = tuple(kw["shape"])
            paths[name] = getattr(datasets, refs[name]["generator"])(
                os.path.join(tmp, name + ".g2o"), **kw)
        phase("[data] generated " + ", ".join(
            f"{k} ({refs[k]['n']} poses, {refs[k]['m']} edges)"
            for k in paths))

        rows = kernel_phase(torch, paths["grid10k"])

        os.environ.pop("DCORA_SPMM_PACK", None)  # the default strip pack
        products, restore = counting_products(tiled)
        try:
            spmm.reset_launches()
            walls = {name: slice_phase(torch, name, paths[name], refs[name])
                     for name in ("smallGrid3D", "grid10k")}
            counts = spmm.launch_counts()
        finally:
            restore()
        require(counts["spmm_sym"] == products[0] > 0,
                f"the main path did not launch the strip kernel once per "
                f"tile product: {counts}, {products[0]} products")
        require(counts["spmm_paired"] == 0 and counts["spmm_symmetric"] == 0,
                f"the default solve launched another SpMM kernel: {counts}")
        phase(f"[launches] default pack: {counts}, {products[0]} tile "
              f"products (10,648-pose grid wall {walls['grid10k']:.2f}s)")
        paired = paired_phase(torch, paths["grid10k"], refs["grid10k"])
        benched = bench_phase(torch, paths["grid10k"])

    # the row each kernel's path launches most: f64 at r_pad 8 for the
    # certified solves (the f64-tile phase's tCG product), f32 at r_pad 8
    # for spmm_bench
    launches = dict(spmm_sym=counts["spmm_sym"],
                    spmm_tile=benched["spmm_symmetric"],
                    spmm_paired=paired["spmm_paired"])
    main_dtype = dict(spmm_sym="float64", spmm_tile="float32",
                      spmm_paired="float64")
    entries = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        main_row = next(r for r in mine if r["dtype"] == main_dtype[name]
                        and r["r_pad"] == 8 and r["live"] == 8)
        entries.append(dict(meta, launches=launches[name],
                            max_abs_err=max(r["max_abs_err"] for r in mine),
                            **{k: main_row[k] for k in (
                                "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}))
    elapsed = time.perf_counter() - t_start
    phase(f"[done] {elapsed:.1f}s after the device check")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
