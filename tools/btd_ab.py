"""The block-tridiagonal (BTD) preconditioner solve timed in two checkouts,
in turns.

    python tools/btd_ab.py OTHER_TREE [--out FILE]

OTHER_TREE is another checkout of the repository (the parent commit, say,
unpacked with ``git archive`` into ``checkouts/``, which ``.gitignore``
lists).  The script runs four turns, other, this, this, other, each in a
process of its own that imports the ``dcora_tpu_torch`` of its tree; the
set-up and timing helpers come from this checkout's
``dcora_tpu_torch/tools/common.py`` (loaded by path), so both trees are
driven by the same code.  Per turn, on the card: the ra10k set
(``common.ra_set``, 9,750 poses, nt = 366) is built with the BTD factor at
f32 and f64 as the RA driver builds it, and one application of
``tiled.precondition_flat`` (whatever the tree does with a CUDA tensor:
a CUDA graph of cuBLASLt products before the BTD kernel, the kernel after)
is timed at r_pad 8 and 16 with CUDA events (``common.LAUNCHES`` back to
back after a warm-up, median of 3 turns), beside its error against the
plain loop ``tiled._precondition_btd`` relative to max|Y|; then the ms per
iteration of a 100-iteration flat tCG solve (``rtr.truncated_cg`` on
``rtr.FLAT_BACKEND``, the RA tile phases' solver, each iteration one tile
product and one BTD application) at r_pad 8 from a random point on the
manifold, with the Hessian's Weingarten term left out so that it runs all
its iterations (CUDA events around whole solves, host issue included,
median of 3 turns).

Prints one JSON object per turn and, with ``--out``, writes them all
there.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ("other", "this", "this", "other")
TCG_ITERS = 100


def _common():
    spec = importlib.util.spec_from_file_location(
        "btd_ab_common",
        os.path.join(HERE, "dcora_tpu_torch", "tools", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn() -> dict:
    """One turn in the tree whose root is first on sys.path."""
    import torch

    import dcora_tpu_torch
    from dcora_tpu_torch.core import rtr, spmm, tiled
    from dcora_tpu_torch.solvers import make_preconditioner, precond_reg

    common = _common()
    common.require_cuda("btd_ab")
    spmm.build_all()
    rec = dict(package=os.path.dirname(dcora_tpu_torch.__file__),
               platform=common.platform("cuda"), rows=[], tcg=[])
    with tempfile.TemporaryDirectory() as tmp:
        g = common.load_graph(common.ra_set(tmp, 1950), 3)
    P = g.problem_data(device="cuda")
    M, reg = make_preconditioner(g, P), precond_reg(g, P)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for dtype in (torch.float32, torch.float64):
        TP = tiled.build_tiled(P, g.dims, dtype=dtype, precond=M, reg=reg,
                               tile_precond="btd", pack="bucketed")
        for r_pad in (8, 16):
            V = torch.randn((r_pad, TP.meta.kpad), generator=gen,
                            dtype=dtype, device="cuda")
            Y = tiled.precondition_flat(TP, V)
            plain = tiled._precondition_btd(TP, V)
            ms = common.time_turns_ms(
                [functools.partial(tiled.precondition_flat, TP, V)])[0]
            rec["rows"].append(dict(
                dtype=str(dtype).split(".")[-1], r_pad=r_pad,
                nt=TP.meta.nt, ms=ms,
                rel_err=float((Y - plain).abs().max())
                / float(plain.abs().max())))
        X0 = torch.randn((8, TP.meta.kpad), generator=gen, dtype=dtype,
                         device="cuda")
        Xf = tiled.retract_flat(TP.meta, torch.zeros_like(X0), X0)
        grad = rtr.FLAT_BACKEND.tangent(TP, Xf, tiled.egrad_flat(TP, Xf))
        radius = torch.tensor(1e8, dtype=torch.float64, device="cuda")
        zero = torch.zeros_like(Xf)
        solve = functools.partial(rtr.truncated_cg, TP, Xf, grad, zero,
                                  None, radius, TCG_ITERS, 1e-12, 1.0,
                                  be=rtr.FLAT_BACKEND)
        iters = int(solve().inner_iters)
        ms = common.time_turns_ms([solve], n=1)[0]
        rec["tcg"].append(dict(dtype=str(dtype).split(".")[-1],
                               iterations=iters,
                               ms_per_iteration=ms / iters))
        del TP
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--out", default=None)
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.turn:  # a child: the tree to import is a.turn
        sys.path.insert(0, a.turn)
        rec = turn()
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
            rc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn",
                 trees[side], "--out", js], cwd=trees[side],
                env=env).returncode
            rec = dict(turn=i, side=side, tree=trees[side], rc=rc)
            if rc == 0:
                with open(js) as fh:
                    rec.update(json.load(fh))
            records.append(rec)
            print(json.dumps(rec), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0 if all(r["rc"] == 0 for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
