"""The robust and multi-robot slice of the PyTorch port on the card.

  * Kernel 1 (csrc/spmm_sym.cu, through tiled.apply_tiled) on the Q of a
    GNC stage: a 216-pose grid with planted outlier loop closures, the
    rejected ones at weight 0 and others at partial weights.  The strip
    CSR drops the sub-blocks that the zero weights empty, where the dense
    tiles keep them; the kernel agrees with its plain version and with the
    dense-tile reference to 1e-12 of max|W| in f64 and 1e-5 in f32 (a
    different summation order plus f32 rounding, as
    tests/test_torch_spmm_cuda.py).
  * One agent's update_X (the one-accepted-step RTR on the restricted
    problem, its tCG replayed as a CUDA graph) on the card against the
    same agent on the CPU: the same number of tries and acceptance, and
    the iterate to 1e-9 of its largest entry over three rounds (the card's
    products sum in other orders than the CPU's, and CG carries that
    along).

Imports only torch, numpy and the port, so it runs where JAX is not
installed; every test skips without a CUDA device.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_robust_cuda.py
"""

import numpy as np
import pytest
import torch

from dcora_tpu_torch import datasets
from dcora_tpu_torch.core import spmm, tiled
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.solvers import build_pgo_graph, make_preconditioner

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.fixture(scope="module")
def corrupted(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = datasets.generate_grid_g2o(
        str(tmp_path_factory.mktemp("gnc") / "g216.g2o"), shape=(6, 6, 6),
        seed=5)
    ds = read_g2o_file(path)
    ms, outliers = datasets.corrupt_with_outliers(ds.pose_pose_measurements,
                                                  frac=0.15, seed=7)
    return ms, outliers


def _stage_graph(ms, outliers, weighted: bool):
    """The graph of a GNC stage: planted edges rejected (weight 0), every
    third other loop closure at a partial weight."""
    for i, m in enumerate(ms):
        if m.fixedWeight:
            continue
        m.weight = 1.0
        if weighted:
            m.weight = 0.0 if (m.p1, m.p2) in outliers else \
                (0.37 if i % 3 == 0 else 1.0)
    return build_pgo_graph(ms, r=5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r_pad", [8, 16])
def test_kernel_on_gnc_stage_q_matches_plain(corrupted, dtype, r_pad):
    ms, outliers = corrupted
    TPs = {}
    for weighted in (False, True):
        g = _stage_graph(ms, outliers, weighted)
        P = g.problem_data(device="cuda")
        TPs[weighted] = tiled.build_tiled(P, g.dims, dtype=dtype,
                                          precond=make_preconditioner(g, P))
    TP = TPs[True]
    # the zero weights empty whole sub-blocks: the strips drop them, the
    # dense tiles keep the (now zero) tiles' places
    assert TP.Q.strips.src.numel() < TPs[False].Q.strips.src.numel()
    assert TP.Q.tiles.shape == TPs[False].Q.tiles.shape
    nblk = int(spmm.nonempty_blocks(TP.Q.tiles.cpu().numpy()).sum())
    assert spmm.BLOCK ** 2 * nblk <= TP.Q.strips.vals.numel()
    gen = torch.Generator(device="cuda").manual_seed(r_pad)
    X = torch.randn((r_pad, TP.meta.kpad), generator=gen, dtype=dtype,
                    device="cuda")
    before = spmm.spmm_sym.launches
    W = tiled.apply_tiled(TP, X)
    assert spmm.spmm_sym.launches == before + 1
    plain = spmm.spmm_strips_plain(TP.Q.strips, X)
    dense = spmm.spmm_sym_plain(TP.Q.tiles, TP.Q.tile_rows, TP.Q.tile_cols,
                                X)
    torch.cuda.synchronize()
    assert W.is_cuda and W.dtype == dtype
    assert _rel_err(W, plain) <= RTOL[dtype]
    assert _rel_err(W, dense) <= RTOL[dtype]


def _agent(ms_all, device):
    from dcora_tpu_torch.agent import Agent
    from dcora_tpu_torch.core.lifted import RAState
    from dcora_tpu_torch.drivers.multi_robot_pgo import partition_measurements
    from dcora_tpu_torch.types import (AgentParameters, AgentState,
                                       AgentStatus, PoseID)

    n, robots, r, d = 216, 3, 5, 3
    odo, priv, shared, _ = partition_measurements(ms_all, n, robots)
    rng = np.random.default_rng(0)
    A = np.tile(np.eye(r, d), (n, 1, 1)) + 0.1 * rng.standard_normal(
        (n, r, d))
    U, _, Vt = np.linalg.svd(A, full_matrices=False)
    rot = U @ Vt
    trn = np.cumsum(np.full((n, r), 0.2), axis=0) + \
        0.3 * rng.standard_normal((n, r))
    npr = n // robots
    lift = np.eye(r, d)
    a = Agent(1, AgentParameters(d=d, r=r, robotIDs=frozenset(range(3))),
              device=device)
    a.set_lifting_matrix(lift)
    a.set_measurements(odo[1] + priv[1] + shared[1])
    a.initialize()
    a.set_X(RAState(*(torch.as_tensor(x) for x in (
        rot[npr:2 * npr], np.zeros((0, r)), trn[npr:2 * npr]))))
    for nb in (0, 2):
        a.set_neighbor_status(AgentStatus(nb, AgentState.INITIALIZED, 0, 0,
                                          False, 0.0))
        a.update_neighbor_states(nb, {
            PoseID(nb, i): np.concatenate(
                [rot[nb * npr + i], trn[nb * npr + i][:, None]], axis=1)
            for i in range(npr)})
    return a


def test_agent_update_x_on_card_matches_cpu(corrupted):
    ms, _ = corrupted
    cuda, cpu = _agent(ms, "cuda"), _agent(ms, "cpu")
    for _ in range(3):
        assert cuda.update_X(True, acceleration=False)
        assert cpu.update_X(True, acceleration=False)
        rc, rh = cuda.local_opt_result, cpu.local_opt_result
        assert rc.outer_iters == rh.outer_iters
        assert rc.accepted == rh.accepted
        assert cuda.get_X().rot.is_cuda
        scale = max(float(x.abs().max()) for x in cpu.get_X() if x.numel())
        for x, y in zip(cuda.get_X(), cpu.get_X()):
            if x.numel():
                assert float((x.cpu() - y).abs().max()) <= 1e-9 * scale
    # the tCG graph was captured once and replayed for every round
    assert cuda._cached_graph is not None
    assert cuda._cached_graph.graph is not None
