"""The CUDA SpMM kernel on the card, against its plain PyTorch version.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed.  Every test needs a CUDA device and skips without one; on the
card run it with

    python -m pytest --noconftest -m cuda tests/test_torch_spmm_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX).
Tolerances are relative to max|W|: 1e-12 in f64 and 1e-5 in f32, for a
different summation order (plus f32 rounding).
"""

import numpy as np
import pytest
import torch

from dcora_tpu_torch import datasets
from dcora_tpu_torch.core import spmm, tiled
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.io import read_g2o_file

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """A 216-pose grid: 7 tile columns with forward and transposed
    entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = datasets.generate_grid_g2o(
        str(tmp_path_factory.mktemp("g") / "grid6.g2o"), shape=(6, 6, 6),
        seed=3)
    g = LocalGraph(0, 5, 3)
    g.set_measurements(read_g2o_file(path).pose_pose_measurements)
    return g, g.problem_data(device="cuda")


def _tiled(problem, dtype):
    g, P = problem
    return tiled.build_tiled(P, g.dims, dtype=dtype)


def _operand(TP, r_pad, live, dtype):
    gen = torch.Generator(device="cuda").manual_seed(r_pad * 100 + live)
    X = torch.zeros((r_pad, TP.meta.kpad), dtype=dtype, device="cuda")
    X[:live] = torch.randn((live, TP.meta.kpad), generator=gen, dtype=dtype,
                           device="cuda")
    return X


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r_pad,live", [(8, 8), (16, 16), (8, 1), (24, 20)])
def test_kernel_matches_plain_on_card(problem, dtype, r_pad, live):
    TP = _tiled(problem, dtype)
    assert int(TP.Q.out_ptr[-1]) > TP.Q.tiles.shape[0] > TP.meta.nt
    X = _operand(TP, r_pad, live, dtype)
    before = spmm.spmm_sym.launches
    W = tiled.apply_tiled(TP, X)
    assert spmm.spmm_sym.launches == before + 1
    ref = spmm.spmm_sym_plain(TP.Q.tiles, TP.Q.tile_rows, TP.Q.tile_cols, X)
    torch.cuda.synchronize()
    assert W.is_cuda and W.dtype == dtype and W.shape == X.shape
    err = float((W - ref).abs().max()) / float(ref.abs().max())
    assert err <= RTOL[dtype], err
    assert not W[live:].any()  # zero rank rows stay zero


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_is_deterministic(problem, dtype):
    """Owner-computes with a fixed summation order: launches agree bit for
    bit."""
    TP = _tiled(problem, dtype)
    X = _operand(TP, 8, 8, dtype)
    W1, W2 = tiled.apply_tiled(TP, X), tiled.apply_tiled(TP, X)
    assert torch.equal(W1, W2)


def test_kernel_raises_on_what_it_does_not_take(problem):
    """A CUDA tensor launches the kernel or raises; it never falls back."""
    TP = _tiled(problem, torch.float64)
    Q = TP.Q
    X = _operand(TP, 8, 8, torch.float64)
    before = spmm.spmm_sym.launches
    with pytest.raises(ValueError, match="int32"):
        spmm.spmm_sym(Q.tiles, Q.tile_rows, Q.tile_cols, Q.out_ptr.long(),
                      Q.ent_tile, Q.ent_src, X)
    with pytest.raises(ValueError, match="contiguous"):
        spmm.spmm_sym(Q.tiles, Q.tile_rows, Q.tile_cols, Q.out_ptr,
                      Q.ent_tile, Q.ent_src,
                      X.t().contiguous().t())
    with pytest.raises(ValueError, match="different devices"):
        spmm.spmm_sym(Q.tiles.cpu(), Q.tile_rows, Q.tile_cols, Q.out_ptr,
                      Q.ent_tile, Q.ent_src, X)
    assert spmm.spmm_sym.launches == before
    np.testing.assert_array_equal(spmm.build_output_csr(
        Q.tile_rows.cpu().numpy(), Q.tile_cols.cpu().numpy(), TP.meta.nt)[0],
        Q.out_ptr.cpu().numpy())
