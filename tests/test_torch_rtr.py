"""Riemannian trust region of the PyTorch port vs the JAX package: N outer
iterations on each backend from the same start give the same iterate and
the same f."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dcora_tpu.core.problem as jprob
import dcora_tpu.core.rtr as jrtr
import dcora_tpu.core.tiled as jtiled
import dcora_tpu_torch.core.rtr as trtr
import dcora_tpu_torch.core.tiled as ttiled
from dcora_tpu_torch import convert
from torch_port_common import (
    assert_close,
    assert_state_close,
    build_graphs,
    jax_state,
    random_graph_spec,
    random_state_arrays,
    torch_state,
)

N_OUTER = 4


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    gj, gt = build_graphs(random_graph_spec(rng, n=30, l=6, b=4), r=5)
    Pj = gj.problem_data()
    Mj = jprob.build_preconditioner_host(Pj, gj.n, gj.l, gj.b, gj.d, 0.1)
    arrs = random_state_arrays(rng, gj.dims, 5)
    return dict(gj=gj, gt=gt, Pj=Pj, Pt=convert.problem_data(Pj), Mj=Mj,
                Mt=convert.preconditioner(Mj), Xj=jax_state(arrs),
                Xt=torch_state(arrs))


def _cfgs(max_outer):
    kw = dict(gradnorm_tol=1e-12, max_outer=max_outer, max_inner=30)
    return jrtr.RTRConfig(**kw), trtr.RTRConfig(**kw)


def test_rtr_edge_backend(case):
    cj, ct = _cfgs(N_OUTER)
    rj = jrtr.rtr(case["Pj"], case["Pj"].prior_G, case["Mj"], case["Xj"], cj)
    rt = trtr.rtr(case["Pt"], case["Pt"].prior_G, case["Mt"], case["Xt"], ct)
    assert rt.outer_iters == int(rj.outer_iters) == N_OUTER
    assert_state_close(rt.X, rj.X)
    assert_close(rt.f_final, rj.f_final)
    assert_close(rt.gradnorm_final, rj.gradnorm_final, rtol=1e-8)
    assert_close(rt.radius_final, rj.radius_final, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", [False, "btd"])
def test_rtr_flat_backend(case, dtype, mode):
    gj, gt = case["gj"], case["gt"]
    jdt = np.float64 if dtype == torch.float64 else np.float32
    TPj = jtiled.build_tiled(case["Pj"], gj.dims, dtype=jdt,
                             precond=case["Mj"], tile_precond=mode,
                             with_pallas=False)
    TPt = ttiled.build_tiled(case["Pt"], gt.dims, dtype=dtype,
                             precond=case["Mt"], tile_precond=mode)
    Xj = jtiled.to_flat(TPj, case["Xj"], r_pad=8).astype(jdt)
    Xt = ttiled.to_flat(TPt, case["Xt"], r_pad=8).to(dtype)
    Gj = jtiled.to_flat(TPj, case["Pj"].prior_G, r_pad=8).astype(jdt)
    Gt = ttiled.to_flat(TPt, case["Pt"].prior_G, r_pad=8).to(dtype)
    # f32 trajectories drift apart by rounding alone, so hold them to one
    # outer iteration at the f32 bar
    n = N_OUTER if dtype == torch.float64 else 1
    cj, ct = _cfgs(n)
    rj = jrtr.rtr(TPj, Gj, None, Xj, cj, be=jrtr.FLAT_BACKEND)
    rt = trtr.rtr(TPt, Gt, None, Xt, ct, be=trtr.FLAT_BACKEND)
    assert rt.outer_iters == int(rj.outer_iters) == n
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    assert rt.X.dtype == dtype
    assert_close(rt.X, rj.X, rtol=tol)
    assert_close(rt.f_final, rj.f_final, rtol=tol)


def test_truncated_cg_counts_and_freezes(case):
    """tCG on the edge backend: same step, same inner-iteration count, and
    iterations issued after convergence leave the result unchanged."""
    Xj, Xt = case["Xj"], case["Xt"]
    Pj, Pt = case["Pj"], case["Pt"]
    egj = jprob.euclidean_gradient(Pj, Xj, Pj.prior_G)
    gj = jrtr.RA_BACKEND.tangent(Pj, Xj, egj)
    egt = convert.ra_state(egj)
    gt = convert.ra_state(gj)
    for radius in (0.05, 100.0):
        rj = jrtr.truncated_cg(Pj, Xj, gj, egj, case["Mj"], radius, 40,
                               0.1, 1.0)
        rt = trtr.truncated_cg(Pt, Xt, gt, egt, case["Mt"],
                               torch.tensor(radius, dtype=torch.float64),
                               40, 0.1, 1.0)
        assert int(rt.inner_iters) == int(rj.inner_iters)
        assert_state_close(rt.eta, rj.eta)
        assert_state_close(rt.Heta, rj.Heta)


class _EagerGraph(trtr.TCGGraph):
    """TCGGraph whose recorded body runs eagerly at each replay: its
    bookkeeping (static buffers, STEPS iterations per replay, the masked
    overshoot, reloading) on the CPU, where no CUDA graph exists."""

    def _record(self, body):
        self.graph = SimpleNamespace(replay=body)


@pytest.mark.parametrize("max_inner,kappa", [(3, 1e-12), (6, 1e-12),
                                             (40, 0.1)])
def test_truncated_cg_replayed_steps(case, max_inner, kappa):
    """tCG issued TCGGraph.STEPS iterations per replay, with one graph
    reloaded for a second radius, against the JAX package's tCG: the
    same count and step.  kappa 1e-12 runs to max_inner (3 and 6 are not
    multiples of STEPS); kappa 0.1 stops on the residual first."""
    Xj, Xt = case["Xj"], case["Xt"]
    Pj, Pt = case["Pj"], case["Pt"]
    egj = jprob.euclidean_gradient(Pj, Xj, Pj.prior_G)
    gj = jrtr.RA_BACKEND.tangent(Pj, Xj, egj)
    egt = convert.ra_state(egj)
    gt = convert.ra_state(gj)
    graph = _EagerGraph(trtr.RA_BACKEND, Pt, case["Mt"], max_inner)
    for radius in (100.0, 0.05):
        rj = jrtr.truncated_cg(Pj, Xj, gj, egj, case["Mj"], radius,
                               max_inner, kappa, 1.0)
        rt = trtr.truncated_cg(Pt, Xt, gt, egt, case["Mt"],
                               torch.tensor(radius, dtype=torch.float64),
                               max_inner, kappa, 1.0, graph=graph)
        assert int(rt.inner_iters) == int(rj.inner_iters) <= max_inner
        assert_state_close(rt.eta, rj.eta)
        assert_state_close(rt.Heta, rj.Heta)
