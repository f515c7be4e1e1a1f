"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path -- the certified single-robot PGO staircase of
``dcora_tpu_torch.drivers.single_robot_pgo.run(..., certify=True,
device="cuda")`` -- on the generated smallGrid3D set (125 poses) and on the
10,648-pose grid (``generate_large_scale_g2o(target_poses=10_000)``), after
it has built the SpMM kernel from ``dcora_tpu_torch/csrc/spmm_sym.cu`` and
held it against its plain PyTorch version on the card.  Sequential and
fail-closed: every phase prints a line and any failure raises, so the exit
code is non-zero and the result line is not printed.  Imports nothing of
JAX.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(HERE, "tests", "data",
                         "torch_port_pgo_reference.json")
KERNEL = dict(name="spmm_sym", route="cuda",
              source="dcora_tpu_torch/csrc/spmm_sym.cu",
              replaces="dcora_tpu/core/pallas_spmm.py:307")
# relative to max|W|: a different summation order, plus f32 rounding
TOL = {"float32": 1e-5, "float64": 1e-12}
F_RTOL = 1e-8  # certified f* against the JAX reference values
LAUNCHES = 100  # launches per timing


def phase(msg: str):
    print(msg, flush=True)


def require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def device_phase(torch):
    require(torch.cuda.is_available(),
            "torch.cuda.is_available() is false; this script runs only on "
            "a CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    phase(f"[device] {name}; torch {torch.__version__}; CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    power = smi.stdout.strip().splitlines()[0]
    print(power, flush=True)
    return name, power


def time_ms(torch, fn, n=LAUNCHES):
    """Milliseconds per launch of fn: CUDA events around n launches issued
    back to back, after a warm-up."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def time_pair_ms(torch, kern, plain, rounds=3):
    """Median per-launch ms of the kernel and of its plain version, timed in
    turns (kernel, plain, plain, kernel, ...) on the same inputs."""
    ts = {kern: [], plain: []}
    for i in range(rounds):
        for fn in ((kern, plain) if i % 2 == 0 else (plain, kern)):
            ts[fn].append(time_ms(torch, fn))
    return tuple(sorted(ts[fn])[rounds // 2] for fn in (kern, plain))


def kernel_phase(torch, path10k):
    """The kernel against spmm_sym_plain on the card at the main path's
    shapes: r_pad 8 and 16 in f32 and f64, and r_pad 8 with one live row
    (the tiled Lanczos operand)."""
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.solvers import make_preconditioner

    ds = read_g2o_file(path10k)
    g = LocalGraph(0, 5, 3)
    g.set_measurements(ds.pose_pose_measurements)
    P = g.problem_data(device="cuda")
    M = make_preconditioner(g, P)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        TP = tiled.build_tiled(P, g.dims, dtype=dtype, precond=M)
        Q = TP.Q
        for r_pad, live in ((8, 8), (16, 16), (8, 1)):
            X = torch.zeros((r_pad, TP.meta.kpad), dtype=dtype,
                            device="cuda")
            X[:live] = torch.randn((live, TP.meta.kpad), generator=gen,
                                   dtype=dtype, device="cuda")

            def kern():
                return spmm.spmm_sym(Q.tiles, Q.tile_rows, Q.tile_cols,
                                     Q.out_ptr, Q.ent_tile, Q.ent_src, X)

            def plain():
                return spmm.spmm_sym_plain(Q.tiles, Q.tile_rows,
                                           Q.tile_cols, X)

            W, Wp = kern(), plain()
            torch.cuda.synchronize()
            require(bool(torch.isfinite(W).all()), "kernel output not finite")
            abs_err = float((W - Wp).abs().max())
            scale = float(Wp.abs().max())
            dt = str(dtype).split(".")[-1]
            require(abs_err <= TOL[dt] * scale,
                    f"kernel disagrees with plain ({dt}, r_pad {r_pad}, "
                    f"live {live}): {abs_err:.3e} > {TOL[dt]:.0e} * "
                    f"{scale:.3e}")
            ms, plain_ms = time_pair_ms(torch, kern, plain)
            rows.append(dict(dtype=dt, r_pad=r_pad, live=live,
                             max_abs_err=abs_err, ms=ms, plain_ms=plain_ms))
            phase(f"[kernel] {dt} r_pad={r_pad} live_rows={live} "
                  f"tiles={Q.tiles.shape[0]} nt={TP.meta.nt} "
                  f"max_abs_err={abs_err:.3e} (rel {abs_err / scale:.2e}) "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (per launch, "
                  f"{LAUNCHES} back to back, median of 3 turns)")
    return rows


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


def main() -> int:
    require(os.path.isdir(os.path.join(HERE, "dcora_tpu_torch")),
            "dcora_tpu_torch/ is not beside this script: run it from a "
            "checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    kind, _ = device_phase(torch)

    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.core import spmm

    t0 = time.perf_counter()
    spmm.LIBRARY.get()
    phase(f"[build] {spmm.LIBRARY.path()} in "
          f"{time.perf_counter() - t0:.2f}s (nvcc "
          f"{spmm.LIBRARY.build_seconds or 0.0:.2f}s)")

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

        spmm.spmm_sym.launches = 0
        walls = {name: slice_phase(torch, name, paths[name], refs[name])
                 for name in ("smallGrid3D", "grid10k")}
        launches = spmm.spmm_sym.launches
    require(launches > 0, "the main path never launched the SpMM kernel")
    phase(f"[launches] spmm_sym launched {launches} times on the main path "
          f"(10,648-pose grid wall {walls['grid10k']:.2f}s)")

    # f64 at r_pad 8, all rows live: the f64-tile phase's tCG product, the
    # shape the 10,648-pose solve launches most
    main_row = next(r for r in rows if r["dtype"] == "float64"
                    and r["r_pad"] == 8 and r["live"] == 8)
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"])]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
