"""The g2o100k slice's pieces on the card: kernel 1 (spmm_sym) against its
plain version (spmm_strips_plain) on the Q of a 20^3 = 8,000-pose grid of
the g2o100k generator, f32 and f64; utils.timing synchronizing on CUDA
tensors; the native readers and preconditioner build on the card's host,
and the batched eigh of the retraction at a size cuSOLVER refuses in one
call.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed.  Every test needs a CUDA device and skips without one; on the
card run it with

    python -m pytest --noconftest -m cuda tests/test_torch_g2o100k_cuda.py

Tolerances are relative to max|W|: 1e-12 in f64 and 1e-5 in f32 (another
summation order, plus f32 rounding), as tests/test_torch_spmm_cuda.py.
"""

import time

import numpy as np
import pytest
import torch

from dcora_tpu_torch import datasets, native, solvers
from dcora_tpu_torch.core import manifold, spmm, tiled
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.io import read_g2o_file, read_pyfg_file
from dcora_tpu_torch.utils.timing import PhaseTimer, SimpleTimer

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = datasets.generate_large_scale_g2o(
        str(tmp_path_factory.mktemp("g") / "grid20.g2o"), target_poses=8000)
    ds = read_g2o_file(path)
    g = LocalGraph(0, 5, 3)
    g.set_measurements(ds.pose_pose_measurements)
    return ds, g, g.problem_data(device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r_pad,live", [(8, 8), (8, 1), (16, 16)])
def test_kernel1_against_plain_on_the_8000_pose_grid(grid, dtype, r_pad,
                                                     live):
    _, g, P = grid
    assert g.n == 8000
    TP = tiled.build_tiled(P, g.dims, dtype=dtype,
                           precond=solvers.make_preconditioner(g, P))
    gen = torch.Generator(device="cuda").manual_seed(r_pad + live)
    X = torch.zeros((r_pad, TP.meta.kpad), dtype=dtype, device="cuda")
    X[:live] = torch.randn((live, TP.meta.kpad), generator=gen, dtype=dtype,
                           device="cuda")
    spmm.reset_launches()
    W = spmm.spmm_sym(TP.Q.strips, X)
    assert spmm.launch_counts()["spmm_sym"] == 1
    Wp = spmm.spmm_strips_plain(TP.Q.strips, X)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(W).all())
    err = float((W - Wp).abs().max())
    assert err <= RTOL[dtype] * float(Wp.abs().max())
    assert not W[live:].any()
    assert torch.equal(W, spmm.spmm_sym(TP.Q.strips, X))  # deterministic


def test_timers_synchronize_cuda_tensors(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn((4096, 4096), device="cuda")
    real, devices = torch.cuda.synchronize, []

    def sync(device=None):
        devices.append(device)
        real(device)

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    t = SimpleTimer()
    t.tic()
    y = x @ x
    ms = t.toc(block_on={"y": [y], "cpu": torch.ones(1)})
    assert devices == [y.device] and ms > 0
    pt = PhaseTimer()
    with pt.phase("mm", block_on=(y,)):
        y = x @ x
    assert pt.count["mm"] == 1 and len(devices) == 2
    # a synchronized time covers the device work: at least what a second
    # synchronized product takes
    real()
    t0 = time.perf_counter()
    x @ x
    real()
    assert ms >= 0.5 * (time.perf_counter() - t0) * 1e3


def test_native_readers_on_the_cards_host(grid, tmp_path):
    ds, g, P = grid
    assert native.available(), native.build_error
    assert ds.reader == "native" and len(ds.pose_pose_measurements) > 0
    pyfg = datasets.generate_ra_slam_pyfg(str(tmp_path / "ra.pyfg"))
    assert read_pyfg_file(pyfg).reader == "native"
    assert solvers.precond_build() == "native"
    M = solvers.make_preconditioner(g, P)
    assert M.pose_inv.is_cuda and M.pose_inv.shape == (8000, 4, 4)
    Mh = solvers.make_preconditioner(g, g.problem_data(device="cpu"))
    np.testing.assert_array_equal(M.pose_inv.cpu().numpy(),
                                  Mh.pose_inv.numpy())


def test_eigh_of_a_g2o100k_sized_batch():
    """The retraction's inverse square roots of 97,336 3x3 blocks (g2o100k)
    on the card, in pieces, against the CPU: in f64 on Gram matrices of
    Gaussian 5x3 blocks (condition numbers up to ~1e3), in f32 on
    near-identity ones, as the retraction's (X + V)^T (X + V) are (f32's
    error grows with the condition number: 3.8e-4 of the largest entry on
    the Gaussian ones, on one H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(0)
    A = torch.randn((97_336, 5, 3), generator=gen, dtype=torch.float64)
    G = A.transpose(1, 2) @ A
    near = torch.eye(3, dtype=torch.float64) + 0.02 * G
    for dtype, M, tol in ((torch.float64, G, 1e-10),
                          (torch.float32, near, 1e-5)):
        got = manifold.inv_sqrt_psd(M.to(dtype).cuda()).cpu().double()
        want = manifold.inv_sqrt_psd(M)
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())
