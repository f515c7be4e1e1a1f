"""The port's tiled parallel round (one stacked TiledProblem, every agent's
tile products in one strip-kernel call) against the JAX package's tiled
backend (one TiledProblem per agent, planar RTR with a Newton-Schulz polar
retraction) on the CPU, at float64 tiles:

  * the stacked problem, agent by agent, against the JAX build's: the
    scalar-order maps exactly, the block-Jacobi (per-pose for PGO,
    per-tile for RA) to 1e-14 relative, and the stacked product against
    each agent's own tiles to 1e-12 of max|W|;
  * one round against JAX's planar round to 1e-10 relative (the port's
    flat backend takes the exact polar factor; the two agree to ~2e-15);
  * the batched round against each agent alone through the single-agent
    core.rtr.rtr on the flat backend.

The sets are those of tests/test_torch_parallel.py.
"""

import numpy as np
import pytest
import torch

from torch_port_common import (
    PAR_AGENTS as AGENTS,
    JaxParallelRun,
    parallel_paths,
    rel_err as _rel,
    torch_parallel_problem as _torch_pp,
)

PLANAR_RTOL = 1e-10
ROUND_RTOL = 1e-12
VALUE_RTOL = 1e-14


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(data_dir, tmp_path_factory):
    return parallel_paths(data_dir, str(tmp_path_factory.mktemp("par")))


def _cfg():
    from dcora_tpu_torch.drivers.parallel_pgo import ROUND_CFG

    return ROUND_CFG


@pytest.fixture(scope="module")
def jax_tiled(paths):
    """(JAX tiled ParallelRBCDProblem, packed init, one planar round) per
    set, on a one-device mesh."""
    import jax
    from jax.sharding import Mesh

    from dcora_tpu.core.rtr import RTRConfig
    from dcora_tpu.parallel import rbcd

    out = {}
    mesh = Mesh(np.array(jax.devices()[:1]), ("agents",))
    cfg = RTRConfig(gradnorm_tol=1e-2, max_inner=50,
                    single_accepted_step=True)
    for kind, path in paths.items():
        run = JaxParallelRun(kind, path, 0)
        pp = rbcd.build_parallel_problem(run.pp.graphs, backend="tiled",
                                         tile_dtype=np.float64)
        X1, g1 = rbcd.make_parallel_round(pp, cfg, mesh)(run.X0)
        out[kind] = (pp, run.X0, X1, g1)
    return out


@pytest.mark.parametrize("kind", ["pgo", "ra"])
def test_stacked_tiles_match_jax(kind, paths, jax_tiled):
    import jax

    from dcora_tpu_torch import convert
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.parallel.rbcd import agent_tiled, build_stacked_tiled

    jpp = jax_tiled[kind][0]
    pp = _torch_pp(kind, paths[kind])
    TPs = build_stacked_tiled(pp, 0, AGENTS, torch.float64)
    meta = TPs.meta
    assert TPs.Q.strips.ptr.shape[0] == AGENTS * meta.kpad // spmm.BLOCK + 1
    X = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (8, AGENTS, meta.kpad)))
    W = tiled.apply_tiled(TPs, X)
    assert W.shape == X.shape
    for a in range(AGENTS):
        TPj = convert.tiled_problem(jax.tree.map(lambda x: x[a], jpp.tiled))
        assert TPj.meta == meta
        mine = agent_tiled(TPs, a)
        assert torch.equal(mine.Q.ra_of_fl, TPj.Q.ra_of_fl)
        assert torch.equal(mine.Q.fl_of_ra, TPj.Q.fl_of_ra)
        for name in ("pose_inv", "sph_inv", "lmk_inv", "diag_inv"):
            got, want = getattr(mine, name), getattr(TPj, name)
            assert (got is None) == (want is None), name
            if got is not None:
                assert _rel(got.numpy(), want.numpy()) <= VALUE_RTOL, name
        want = spmm.spmm_sym_plain(TPj.Q.tiles, TPj.Q.tile_rows,
                                   TPj.Q.tile_cols, X[:, a].contiguous())
        assert _rel(W[:, a].numpy(), want.numpy()) <= ROUND_RTOL
    assert (TPs.diag_inv is not None) == (kind == "ra")


@pytest.mark.parametrize("kind", ["pgo", "ra"])
def test_tiled_round_matches_jax_planar(kind, paths, jax_tiled):
    from dcora_tpu_torch import convert
    from dcora_tpu_torch.parallel.rbcd import ParallelRound

    _, X0, X1, g1 = jax_tiled[kind]
    rnd = ParallelRound(_torch_pp(kind, paths[kind]), _cfg(),
                        backend="tiled", tile_dtype=torch.float64)
    Xt, gt = rnd(convert.ra_state(X0))
    for got, want in zip(Xt, X1):
        assert _rel(got.numpy(), want) <= PLANAR_RTOL
    assert _rel(gt.numpy(), g1) <= PLANAR_RTOL


@pytest.mark.parametrize("kind", ["pgo", "ra"])
def test_tiled_round_matches_per_agent_rtr(kind, paths, jax_tiled):
    from dcora_tpu_torch import convert
    from dcora_tpu_torch.parallel.rbcd import ParallelRound, round_per_agent

    pp = _torch_pp(kind, paths[kind])
    X = convert.ra_state(jax_tiled[kind][2])
    Xb, gb = ParallelRound(pp, _cfg(), backend="tiled")(X)
    Xp, gp = round_per_agent(pp, _cfg(), X, backend="tiled")
    for a, b in zip(Xb, Xp):
        assert _rel(a.numpy(), b.numpy()) <= ROUND_RTOL
    assert _rel(gb.numpy(), gp.numpy()) <= ROUND_RTOL
