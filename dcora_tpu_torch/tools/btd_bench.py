"""The block-tridiagonal (BTD) preconditioner solve on the card: its kernel
(``csrc/btd_solve.cu``, ``tiled.btd_solve``) against the plain loop
(``tiled._precondition_btd``) and the bound.

    python -m dcora_tpu_torch.tools.btd_bench [SET] [--dtypes float32 float64]
        [--r-pads 8 16] [--out FILE]

SET is ``ra10k`` (the default: ``tools.common.ra_set``, 9,750 poses, nt =
366, the RA driver's factor), ``ra500``, ``g2o100k`` (the 97,336-pose grid
of ``generate_large_scale_g2o``, nt = 3,042, with the factor that
``DCORA_PGO_PRECOND=btd`` gives it) or a ``.pyfg`` / ``.g2o`` path.  Per
dtype and r_pad, on the same V: the kernel's ms per application by CUDA
events (``common.LAUNCHES`` back to back, median of 3 turns; warm: the
factors stay in L2 as far as they fit) and after a 256 MB
write that flushes L2 (cold: the flush's own time taken off), its device
ms (``torch.profiler``), its error against the plain loop relative to
max|Y|, and whether two applications are bitwise equal; the plain loop's
ms; the bound (``common.btd_bound_ms``).  Prints one line per row and,
with ``--out``, writes one JSON record there.  Refuses to run without
CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from dcora_tpu_torch.tools import common

SETS = {"ra10k": 1950, "ra500": 100}


def load_set(name: str, tmp: str) -> str:
    from dcora_tpu_torch import datasets

    if name in SETS:
        return common.ra_set(tmp, SETS[name])
    if name == "g2o100k":
        return datasets.generate_large_scale_g2o(
            os.path.join(tmp, "g2o100k.g2o"))
    return name


def build(path: str, dtype: torch.dtype):
    """The TiledProblem with the BTD factor that rtr_fast builds for the
    set at rank 3 (RA) or 5 (PGO), on the card; and the host seconds."""
    from dcora_tpu_torch.core import tiled
    from dcora_tpu_torch.solvers import make_preconditioner, precond_reg

    g = common.load_graph(path, 3 if path.endswith(".pyfg") else 5)
    P = g.problem_data(device="cuda")
    t0 = time.perf_counter()
    TP = tiled.build_tiled(P, g.dims, dtype=dtype,
                           precond=make_preconditioner(g, P),
                           reg=precond_reg(g, P), tile_precond="btd")
    torch.cuda.synchronize()
    return TP, time.perf_counter() - t0


def rows_of(TP, dtype, r_pads, gbs):
    from dcora_tpu_torch.core import tiled

    nt, dt = TP.meta.nt, str(dtype).split(".")[-1]
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for r_pad in r_pads:
        V = torch.randn((r_pad, TP.meta.kpad), generator=gen, dtype=dtype,
                        device="cuda")
        plain = tiled._precondition_btd(TP, V)
        scale = float(plain.abs().max())
        def kernel():
            return tiled.btd_solve(TP, V)  # noqa: B023

        warm = common.time_turns_ms([kernel])[0]
        cold = common.time_turns_ms(
            [flush.zero_, lambda: (flush.zero_(), kernel())], n=20)
        plain_ms = common.time_turns_ms(
            [lambda: tiled._precondition_btd(TP, V)],  # noqa: B023
            n=max(1, 3000 // nt))[0]
        bound = common.btd_bound_ms(nt, TP.meta.T, r_pad, dtype, gbs)
        Y, again = kernel(), kernel()
        torch.cuda.synchronize()
        row = dict(dtype=dt, r_pad=r_pad, nt=nt, ms=warm,
                   cold_ms=cold[1] - cold[0],
                   device_ms=common.device_ms(kernel), plain_ms=plain_ms,
                   bound_ms=bound[0], bound_by=bound[1],
                   rel_err=float((Y - plain).abs().max()) / scale,
                   finite=bool(torch.isfinite(Y).all()),
                   repeat_bitwise=bool(torch.equal(Y, again)))
        out.append(row)
        print(f"[btd_bench] {dt} r_pad={r_pad} nt={nt}: {warm:.4f} ms warm, "
              f"{row['cold_ms']:.4f} ms cold, device {row['device_ms']:.4f} "
              f"ms; plain loop {plain_ms:.4f} ms; bound {bound[0]:.4f} ms "
              f"({bound[1]}); rel err {row['rel_err']:.2e}; repeat bitwise "
              f"{row['repeat_bitwise']}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("set", nargs="?", default="ra10k")
    ap.add_argument("--dtypes", nargs="+", default=["float32", "float64"])
    ap.add_argument("--r-pads", nargs="+", type=int, default=[8, 16])
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    common.require_cuda("btd_bench")
    from dcora_tpu_torch.core import kernels

    kernels.library("btd_solve").build()
    gbs = common.nominal_hbm_gbs(torch.cuda.get_device_name(0)) or \
        common.NOMINAL_HBM_GBS[0][1]
    rec = dict(set=a.set, platform=common.platform("cuda"), rows=[],
               build_s={})
    with tempfile.TemporaryDirectory() as tmp:
        path = load_set(a.set, tmp)
        for dt in a.dtypes:
            dtype = getattr(torch, dt)
            TP, rec["build_s"][dt] = build(path, dtype)
            rec["rows"] += rows_of(TP, dtype, a.r_pads, gbs)
            del TP
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(rec, fh, indent=1)
    return 0 if all(r["finite"] and r["repeat_bitwise"]
                    for r in rec["rows"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
