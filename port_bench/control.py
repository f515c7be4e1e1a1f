"""The control of the benchmark's comparison: a run of a cell with the
timed path computed in the nearest precision below the configuration's,
which the comparison has to find not correct.

  * ``certify`` (float64): the program with its own float32 path alone:
    the staircase's and the refine's mixed-precision RTR stop after their
    float32 tile phase (rtr_fast's phases 2 and 3 left out).
  * ``rtr`` on the flat tiles (float32): the reference's trust-region
    solve in the program's place, every vector it stores rounded to
    bfloat16.
  * ``rtr`` on the edge path (float64): the reference's solve in float32.

``control_of(cell)`` puts the control in place of the cell's timed path;
``port_bench/calibrate.py --control-seeds`` runs it on the card at the
cell's own size, and ``port_bench/tests/test_bench_control.py`` on the CPU
at a test's size.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch


@contextmanager
def patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield real
    finally:
        setattr(obj, name, real)


def f32_only_rtr_fast(g, P, M, X0, cfg, G=None, TP=None, skip_coarse=False,
                      stats=None):
    """solvers.rtr_fast with its float32 tile phase alone: the tiled RTR
    in chunks of 25 outers until tolerance or a stall, the result taken
    back to float64 with no float64 phase after it."""
    from dcora_tpu_torch import solvers
    from dcora_tpu_torch.core import problem as prob, rtr, tiled
    from dcora_tpu_torch.core.manifold import project

    r = X0.r
    r_pad = max(8, -(-r // 8) * 8)
    TP = TP or solvers.TileCache()
    tile_pc = solvers._tile_preconditioner(g, P)
    reg = solvers.precond_reg(g, P) if tile_pc else 0.1
    if TP.f32 is None:
        TP.f32 = tiled.build_tiled(P, g.dims, dtype=torch.float32,
                                   precond=M, reg=reg, tile_precond=tile_pc)
    T32 = TP.f32
    Xf = tiled.to_flat(T32, X0, r_pad=r_pad).float()
    Gf = None if G is None else tiled.to_flat(T32, G, r_pad=r_pad).float()
    cfg_c = dataclasses.replace(cfg, gradnorm_tol=max(cfg.gradnorm_tol,
                                                      1e-30), max_outer=25)
    total, prev, rad = 0, float("inf"), None
    while total < cfg.max_outer:
        res = rtr.rtr(T32, Gf, None, Xf, cfg_c, be=rtr.FLAT_BACKEND,
                      radius0=rad)
        Xf, rad = res.X, res.radius_final
        gn = float(res.gradnorm_final)
        total += res.outer_iters
        if gn < cfg_c.gradnorm_tol or res.outer_iters < 25 or gn > 0.7 * prev:
            break
        prev = gn
    X = project(tiled.from_flat(T32, Xf.double(), r=r))
    W = prob.apply_Q(P, X)
    egrad = W if G is None else rtr.tadd(W, G)
    f = prob.cost(P, X, G)
    gn = rtr.tnorm(rtr.RA_BACKEND.tangent(P, X, egrad))
    return rtr.RTRResult(X=X, f_final=f, gradnorm_final=gn,
                         outer_iters=total, accepted=True), TP


@contextmanager
def control_of(cell):
    """The control of `cell` in place of its timed path."""
    from dcora_tpu_torch import staircase
    from dcora_tpu_torch.core import lifted, rtr, tiled

    from port_bench import harness
    from port_bench.reference import graph as ref_graph
    from port_bench.reference.problem import Problem
    from port_bench.reference.rtr import Solver, round_to

    t = cell.traffic
    if t["entry"] == "certify":
        with patched(staircase, "rtr_fast", f32_only_rtr_fast), \
                patched(staircase, "FAST_PATH_MIN_POSES", 0):
            yield
        return
    flat = t["backend"] == "flat"
    lower = round_to(torch.bfloat16 if flat else None)
    budget = harness.budget(t)
    seen = {}

    def make_input(config, seed, directory, i=0):
        seen["path"] = real_make_input(config, seed, directory, i)
        seen["graph"] = g = ref_graph.read(seen["path"])
        seen["rank"] = t["rank"]["pose_graph" if g.is_pgo
                                 else "range_aided"]
        return seen["path"]

    def control_rtr(P, G, M, X0, cfg, be=None, **kw):
        Xs = tiled.from_flat(P, X0.double(), r=seen["rank"]) if flat else X0
        if "problem" not in seen:
            seen["problem"] = Problem(seen["graph"], device=Xs.rot.device,
                                      dtype=torch.float32)
        RP = seen["problem"]
        X, f, gn, it = Solver(RP, budget, lower=lower).solve(RP.flat(*Xs))
        state = lifted.RAState(*RP.state(X.double()))
        out = tiled.to_flat(P, state, r_pad=X0.shape[0]).to(X0.dtype) \
            if flat else state
        return rtr.RTRResult(X=out, f_final=torch.tensor(f),
                             gradnorm_final=torch.tensor(gn),
                             outer_iters=it, accepted=True)

    real_make_input = harness.make_input
    with patched(harness, "make_input", make_input), \
            patched(rtr, "rtr", control_rtr):
        yield
