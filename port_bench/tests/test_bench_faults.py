"""A run with the timed path broken underneath comes out not correct, for
each fault the cells can have: a solve that returns its state unchanged,
half of the batch (the Q product over half the poses, doubled) and an
answer altered where it is produced.  One chip per cell: no exchange
between chips to leave out.  Driven on the CPU past the card check."""

import dataclasses

import pytest
import torch

from dcora_tpu_torch import solvers, staircase
from dcora_tpu_torch.core import lifted, problem as prob, rtr, tiled
from dcora_tpu_torch.drivers import single_robot_pgo
from port_bench.control import patched
from port_bench.tests.conftest import run_small

REAL_RTR = rtr.rtr


def unchanged_rtr(*args, **kw):
    """The solve's steps leave the state as it was: the start comes back,
    with its own cost, counted as the whole budget."""
    args = list(args)
    cfg = args[4]
    args[4] = dataclasses.replace(cfg, max_outer=0)
    return REAL_RTR(*args, **kw)._replace(outer_iters=cfg.max_outer)


def altered_rtr(*args, **kw):
    """The answer altered after the solve produced it: its first pose
    block left at zero."""
    res = REAL_RTR(*args, **kw)
    X = res.X
    if isinstance(X, lifted.RAState):
        X = X._replace(rot=X.rot.clone(), trn=X.trn.clone())
        X.rot[0] = 0
        X.trn[0] = 0
    else:
        X = X.clone()
        X[..., :4] = 0  # the flat layout opens with a pose's d + 1 columns
    return res._replace(X=X)


def half_tiled(TP, X, real=tiled.apply_tiled):
    out = real(TP, X).clone()
    k = out.shape[-1] // 2
    out[..., k:] = 0
    out[..., :k] *= 2
    return out


def half_apply_Q(P, X, real=prob.apply_Q):
    def half(x):
        x = x.clone()
        k = x.shape[0] // 2
        x[k:] = 0
        x[:k] *= 2
        return x
    return lifted.RAState(*(half(x) for x in real(P, X)))


def altered_staircase(*args, real=staircase.riemannian_staircase, **kw):
    res = real(*args, **kw)
    rounded = res.rounded._replace(rot=res.rounded.rot.clone(),
                                   trn=res.rounded.trn.clone())
    rounded.rot[0] = 0
    rounded.trn[0] = 0
    res.rounded = rounded
    return res


def _patches(workload, fault):
    if fault == "unchanged":
        return [(rtr, "rtr", unchanged_rtr), (staircase, "rtr",
                                              unchanged_rtr),
                (solvers, "rtr", unchanged_rtr)]
    if fault == "half":
        return [(tiled, "apply_tiled", half_tiled),
                (prob, "apply_Q", half_apply_Q)]
    if workload.endswith("certify"):
        return [(single_robot_pgo, "riemannian_staircase",
                 altered_staircase)]
    return [(rtr, "rtr", altered_rtr)]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", ["grid3d.certify", "grid3d.tiles",
                                      "ra_lanes.tiles", "ra_lanes.edge"])
def test_fault_is_not_correct(workload, fault):
    ctx = [patched(*p) for p in _patches(workload, fault)]
    for c in ctx:
        c.__enter__()
    try:
        out = run_small(workload)
    except (RuntimeError, ValueError, torch.linalg.LinAlgError):
        return  # a run that dies prints no result: not correct either
    finally:
        for c in reversed(ctx):
            c.__exit__(None, None, None)
    assert not out["correct"], out["checks"]
