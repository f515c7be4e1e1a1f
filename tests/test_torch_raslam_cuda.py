"""The RA-SLAM slice of the PyTorch port on the card: the strip SpMM kernel
(csrc/spmm_sym.cu) on a range-aided Q, the block-tridiagonal (BTD)
preconditioner's kernel (csrc/btd_solve.cu) against its plain loop, and
the RA driver.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed.  Every test needs a CUDA device and skips without one; on the
card run it with

    python -m pytest --noconftest -m cuda tests/test_torch_raslam_cuda.py

The kernel and BTD tests use an RA set of 200 poses, 85 unit spheres and 4
landmarks, so the landmark section starts at scalar column 4 * 200 + 85 =
885, inside a 4-column strip; the driver tests a 30-pose set at low noise.  Tolerances are relative to the reference's max: the kernel's as in
tests/test_torch_spmm_cuda.py (1e-12 f64, 1e-5 f32, a different summation
order); the BTD kernel's 1e-10 in f64 and 1e-4 in f32 (it sums each product
in another order than the loop's matmuls, and the solve's 2 * nt - 1
dependent steps carry that rounding difference along).
"""

import pytest
import torch

from dcora_tpu_torch import datasets
from dcora_tpu_torch.core import spmm, tiled
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.io import read_pyfg_file
from dcora_tpu_torch.io.remap import get_global_measurements
from dcora_tpu_torch.solvers import make_preconditioner, precond_reg
from dcora_tpu_torch.types import GraphType

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
BTD_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.fixture(scope="module")
def ra_path(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return datasets.generate_ra_slam_pyfg(
        str(tmp_path_factory.mktemp("ra") / "ra200.pyfg"), num_robots=5,
        poses_per_robot=40, num_landmarks=4, range_prob=0.5, rot_noise=0.05,
        trans_noise=0.02, range_noise=0.02, seed=3)


@pytest.fixture(scope="module")
def small_path(tmp_path_factory):
    """A 30-pose RA set at low noise (0.01) for the driver: it certifies
    at rank 3 in about a second on a CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return datasets.generate_ra_slam_pyfg(
        str(tmp_path_factory.mktemp("ra") / "ra30.pyfg"), num_robots=3,
        poses_per_robot=10, num_landmarks=2, range_prob=1.0, rot_noise=0.01,
        trans_noise=0.01, range_noise=0.01, seed=3)


@pytest.fixture(scope="module")
def problem(ra_path):
    gm = get_global_measurements(read_pyfg_file(ra_path))
    g = LocalGraph(0, 3, 3, GraphType.RangeAidedSLAMGraph)
    g.set_measurements(gm.relative_measurements)
    assert g.l == 85 and g.b == 4 and (4 * g.n + g.l) % spmm.BLOCK != 0
    return g


def _tiled(g, device, dtype):
    P = g.problem_data(device=device)
    M = make_preconditioner(g, P)
    return tiled.build_tiled(P, g.dims, dtype=dtype, precond=M,
                             reg=precond_reg(g, P), tile_precond="btd")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r_pad", [8, 16])
def test_kernel_on_ra_tiles_matches_plain(problem, dtype, r_pad):
    TP = _tiled(problem, "cuda", dtype)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r_pad", [8, 16, 24])
def test_btd_kernel_matches_loop(problem, dtype, r_pad):
    """The BTD kernel (csrc/btd_solve.cu, one launch per application)
    against the plain loop on the card and on the CPU, on the same factors
    and input; a second call with a new input gives that input's solve,
    and a repeated call the same bits."""
    TP = _tiled(problem, "cuda", dtype)
    TPc = _tiled(problem, "cpu", dtype)
    torch.testing.assert_close(TP.btd_ltil.cpu(), TPc.btd_ltil, rtol=0,
                               atol=0)
    gen = torch.Generator().manual_seed(r_pad)
    for _ in range(2):
        V = torch.randn((r_pad, TP.meta.kpad), generator=gen, dtype=dtype)
        before = tiled.btd_solve.launches
        Y = tiled.precondition_flat(TP, V.cuda())
        again = tiled.btd_solve(TP, V.cuda())
        assert tiled.btd_solve.launches == before + 2
        loop = tiled._precondition_btd(TP, V.cuda())
        cpu = tiled._precondition_btd(TPc, V)
        torch.cuda.synchronize()
        assert Y.is_cuda and Y.shape == V.shape and Y.dtype == dtype
        assert bool(torch.isfinite(Y).all())
        assert torch.equal(Y, again)
        assert _rel_err(Y, loop) <= BTD_RTOL[dtype]
        assert _rel_err(Y.cpu(), cpu) <= BTD_RTOL[dtype]


def _band_problem(nt, dtype, seed):
    """A stand-in TiledProblem over a random band of nt 128 x 128 blocks
    (its sub-diagonal block nt // 2 zero for nt >= 3), factored by
    tiled._factor_btd, on the CPU."""
    import types

    import numpy as np

    T = 128
    rng = np.random.default_rng(seed)
    dense, trow, tcol = [], [], []
    for i in range(nt):
        A = rng.standard_normal((T, T)) / np.sqrt(T)
        dense.append(A @ A.T + np.eye(T))
        trow.append(i)
        tcol.append(i)
        if i:
            L = 0.4 * rng.standard_normal((T, T)) / np.sqrt(T)
            if nt >= 3 and i == nt // 2:
                L[:] = 0.0
            dense += [L, L.T]
            trow += [i, i - 1]
            tcol += [i - 1, i]
    Lt, Sinv = tiled._factor_btd(np.stack(dense), np.array(trow),
                                 np.array(tcol), nt, T, 0.1)
    return types.SimpleNamespace(
        meta=tiled.TiledMeta(d=3, n=0, l=0, b=0, T=T, nt=nt),
        btd_ltil=torch.as_tensor(Lt, dtype=dtype),
        btd_sinv=torch.as_tensor(Sinv, dtype=dtype), btd_layout=None)


@pytest.mark.parametrize("nt", [1, 2, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_btd_kernel_short_bands(dtype, nt):
    """One block, two, and seven with a zero sub-diagonal block (a broken
    band), at r_pad 24: the kernel against the plain loop on the CPU,
    bitwise repeatable; the panel layout of the factors is made once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    TPc = _band_problem(nt, dtype, seed=nt)
    TP = _band_problem(nt, dtype, seed=nt)
    TP.btd_ltil, TP.btd_sinv = TP.btd_ltil.cuda(), TP.btd_sinv.cuda()
    V = torch.randn((24, nt * 128), generator=torch.Generator().manual_seed(
        nt), dtype=dtype)
    Y = tiled.btd_solve(TP, V.cuda())
    layout = TP.btd_layout
    again = tiled.btd_solve(TP, V.cuda())
    torch.cuda.synchronize()
    C = tiled.BTD_CLUSTER
    assert TP.btd_layout is layout
    assert all(p.is_cuda and p.shape == (nt, C, 128, 128 // C)
               for p in layout)
    assert torch.equal(Y, again)
    assert _rel_err(Y.cpu(), tiled._precondition_btd(TPc, V)) <= \
        BTD_RTOL[dtype]


@pytest.mark.parametrize("max_inner", [3, 6])
def test_tcg_graph_matches_loop(problem, max_inner):
    """The edge path's tCG through its CUDA graph against the iterations
    issued one by one, on the card and on the CPU, at two outer points
    (the second reloads the captured graph): the same step count, and eta
    and Heta to 1e-9 of their max.  The card sums in another order than
    the CPU (cuBLAS, the segment sums' long rows), and CG carries such
    differences along: on the CPU a
    1e-15 relative change of the gradient moves Heta by 2.3e-14 after 6
    iterations, 2.6e-12 after 7 and 6.4e-7 after 10 here, so the solves
    are kept short.  Neither max_inner is a multiple of TCGGraph.STEPS,
    so the graph's masked overshoot must leave the result unchanged."""
    from dcora_tpu_torch.core import lifted, manifold, rtr

    g = problem
    # a point past the first outer iterations; kappa 1e-12 and a large
    # radius keep tCG from stopping before max_inner
    Pc = g.problem_data(device="cpu")
    X_start = rtr.rtr(
        Pc, lifted.zeros(g.dims, 4), make_preconditioner(g, Pc),
        manifold.random_state(g.dims, 4, torch.Generator().manual_seed(0)),
        rtr.RTRConfig(max_outer=20, max_inner=50)).X
    out = {}
    for device in ("cuda", "cpu"):
        P = g.problem_data(device=device)
        M = make_preconditioner(g, P)
        X = X_start.to(device)
        graph = rtr.TCGGraph(rtr.RA_BACKEND, P, M, max_inner) \
            if device == "cuda" else None
        runs = []
        for radius in (1e8, 0.5):
            egrad = rtr.RA_BACKEND.applyQ(P, X)
            grad = rtr.RA_BACKEND.tangent(P, X, egrad)
            rad = torch.tensor(radius, dtype=torch.float64, device=device)
            for gr in ((graph, None) if graph else (None,)):
                res = rtr.truncated_cg(P, X, grad, egrad, M, rad, max_inner,
                                       1e-12, 1.0, graph=gr)
                runs.append(res)
            X = manifold.retract(X, lifted.RAState(*(
                0.01 * x for x in grad)))
        out[device] = runs
    cuda, cpu = out["cuda"], out["cpu"]
    for k in range(2):
        graphed, loop, ref = cuda[2 * k], cuda[2 * k + 1], cpu[k]
        assert int(graphed.inner_iters) == int(loop.inner_iters) \
            == int(ref.inner_iters) <= max_inner
        for a, b in ((graphed.eta, loop.eta), (graphed.Heta, loop.Heta),
                     (graphed.eta, ref.eta), (graphed.Heta, ref.Heta)):
            for x, y in zip(a, b):
                assert _rel_err(x.cpu(), y.cpu()) <= 1e-9


@pytest.mark.parametrize("path", ["edge", "tiled"])
def test_raslam_driver_on_card(small_path, monkeypatch, path):
    """The driver certifies on the card, its state stays there, and it
    reaches the CPU run's f* of the same file.  "tiled" lowers
    FAST_PATH_MIN_POSES so the f32/f64 tile phases, the SpMM kernel and
    the BTD kernel run."""
    from dcora_tpu_torch import solvers, staircase
    from dcora_tpu_torch.drivers.single_robot_raslam import run

    if path == "tiled":
        for mod in (solvers, staircase):
            monkeypatch.setattr(mod, "FAST_PATH_MIN_POSES", 1)
    spmm.reset_launches()
    res, g, _ = run(small_path, device="cuda", verbose=False)
    launches = spmm.launch_counts()["spmm_sym"]
    assert res.certified and res.X.rot.is_cuda and res.rounded.sph.is_cuda
    assert (launches > 0) == (path == "tiled")
    ref, _, _ = run(small_path, device="cpu", verbose=False)
    assert ref.certified and res.final_rank == ref.final_rank
    assert abs(res.f_final - ref.f_final) <= 1e-6 * abs(ref.f_final)


def test_raslam_tile_phases_launch_btd_kernel(small_path, monkeypatch):
    """The RA driver's tile phases apply the BTD preconditioner through
    its kernel, and a TiledProblem keeps no CUDA graph of it."""
    import dataclasses

    from dcora_tpu_torch import solvers, staircase
    from dcora_tpu_torch.drivers.single_robot_raslam import run

    for mod in (solvers, staircase):
        monkeypatch.setattr(mod, "FAST_PATH_MIN_POSES", 1)
    spmm.reset_launches()
    res, _, _ = run(small_path, device="cuda", verbose=False)
    counts = spmm.launch_counts()
    assert res.certified
    assert counts["btd_solve"] > 0 and counts["spmm_sym"] > 0
    names = {f.name for f in dataclasses.fields(tiled.TiledProblem)}
    assert "btd_graphs" not in names and not hasattr(tiled, "BTDGraph")
