"""The CUDA SpMM kernels on the card, against their plain PyTorch versions.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed.  Every test needs a CUDA device and skips without one; on the
card run it with

    python -m pytest --noconftest -m cuda tests/test_torch_spmm_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX).
Tolerances are relative to max|W|: 1e-12 in f64 and 1e-5 in f32, for a
different summation order (plus f32 rounding).  The owner-computes kernel
(spmm_sym) is deterministic and tested for it; the atomics kernels
(spmm_symmetric, spmm_grouped / spmm_paired) sum in no fixed order, so for
them repeated launches are held to the same tolerance instead.
"""

import numpy as np
import pytest
import torch

from dcora_tpu_torch import datasets
from dcora_tpu_torch.core import spmm, spmm_pack, tiled
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.tools.spmm_bench import padded_tile_list

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


CASES = [(8, 8), (16, 16), (8, 1), (24, 20)]


def _tiled(problem, dtype, pack="bucketed"):
    g, P = problem
    return tiled.build_tiled(P, g.dims, dtype=dtype, pack=pack)


def _operand(TP, r_pad, live, dtype):
    gen = torch.Generator(device="cuda").manual_seed(r_pad * 100 + live)
    X = torch.zeros((r_pad, TP.meta.kpad), dtype=dtype, device="cuda")
    X[:live] = torch.randn((live, TP.meta.kpad), generator=gen, dtype=dtype,
                           device="cuda")
    return X


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r_pad,live", CASES)
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


def _rel_err(W, ref):
    return float((W - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r_pad,live", CASES)
def test_tile_kernel_matches_plain_on_card(problem, dtype, r_pad, live):
    TP = _tiled(problem, dtype)
    rows, cols, tiles = padded_tile_list(TP.Q)
    assert rows.shape[0] % 8 == 0 and rows.shape[0] > TP.Q.tiles.shape[0]
    X = _operand(TP, r_pad, live, dtype)
    before = spmm.spmm_symmetric.launches
    W = spmm.spmm_symmetric(rows, cols, tiles, X)
    assert spmm.spmm_symmetric.launches == before + 1
    ref = spmm.spmm_symmetric_plain(rows, cols, tiles, X)
    torch.cuda.synchronize()
    assert W.is_cuda and W.dtype == dtype and W.shape == X.shape
    assert _rel_err(W, ref) <= RTOL[dtype]
    assert not W[live:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r_pad,live", CASES)
def test_paired_kernel_matches_plain_on_card(problem, dtype, r_pad, live):
    """apply_tiled on a paired build: R = 2 on the pairs, R = 1 on the
    leftover buckets, all into one W."""
    TP = _tiled(problem, dtype, pack="paired")
    buckets = TP.Q.grp_buckets
    Rs = [2 if b[0].dim() == 2 else 1 for b in buckets]
    assert 2 in Rs and 1 in Rs
    # the graph has off-diagonal (r1, r2) tiles inside a pair
    assert any(bool((gc == gr[:, 1:]).any()) for gr, gc, _ in buckets
               if gr.dim() == 2)
    X = _operand(TP, r_pad, live, dtype)
    before = (spmm.spmm_paired.launches, spmm.spmm_grouped.launches)
    W = tiled.apply_tiled(TP, X)
    assert spmm.spmm_paired.launches == before[0] + Rs.count(2)
    assert spmm.spmm_grouped.launches == before[1] + Rs.count(1)
    ref = spmm.spmm_bucketed_plain(buckets, X)
    ref_sym = spmm.spmm_sym_plain(TP.Q.tiles, TP.Q.tile_rows, TP.Q.tile_cols,
                                  X)
    torch.cuda.synchronize()
    assert W.is_cuda and W.dtype == dtype and W.shape == X.shape
    assert _rel_err(W, ref) <= RTOL[dtype]
    assert _rel_err(W, ref_sym) <= RTOL[dtype]
    assert not W[live:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("G", [2, 8])
def test_grouped_kernel_matches_plain_on_card(problem, dtype, G):
    """R = 1 on the fixed-G layout (zero pad slots at col == row)."""
    TP = _tiled(problem, dtype)
    Q = TP.Q
    gr, gc, gw = spmm.buckets_to_tensors([spmm_pack.build_row_groups(
        Q.tile_rows.cpu().numpy(), Q.tile_cols.cpu().numpy(),
        Q.tiles.cpu().numpy(), T=128, G=G)], dtype, "cuda")[0]
    X = _operand(TP, 8, 8, dtype)
    before = spmm.spmm_grouped.launches
    W = spmm.spmm_grouped(gr, gc, gw, X)
    assert spmm.spmm_grouped.launches == before + 1
    ref = spmm.spmm_grouped_plain(gr, gc, gw, X)
    torch.cuda.synchronize()
    assert _rel_err(W, ref) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_atomics_kernels_repeat_within_tolerance(problem, dtype):
    """Atomics give no fixed summation order: repeated launches need not
    agree bit for bit, but they agree to the kernels' tolerance."""
    TPp = _tiled(problem, dtype, pack="paired")
    rows, cols, tiles = padded_tile_list(TPp.Q)
    X = _operand(TPp, 8, 8, dtype)
    for run in (lambda: spmm.spmm_symmetric(rows, cols, tiles, X),
                lambda: tiled.apply_tiled(TPp, X)):
        W0 = run()
        for _ in range(4):
            assert _rel_err(run(), W0) <= RTOL[dtype]


def test_atomics_kernels_raise_on_what_they_do_not_take(problem):
    """A CUDA tensor launches the kernel or raises; it never falls back."""
    TP = _tiled(problem, torch.float64, pack="paired")
    rows, cols, tiles = padded_tile_list(TP.Q)
    X = _operand(TP, 8, 8, torch.float64)
    pair = next(b for b in TP.Q.grp_buckets if b[0].dim() == 2)
    single = next(b for b in TP.Q.grp_buckets if b[0].dim() == 1)
    before = spmm.launch_counts()
    with pytest.raises(ValueError, match="int32"):
        spmm.spmm_symmetric(rows.long(), cols, tiles, X)
    with pytest.raises(ValueError, match="contiguous"):
        spmm.spmm_symmetric(rows, cols, tiles, X.t().contiguous().t())
    with pytest.raises(TypeError):
        spmm.spmm_symmetric(rows, cols, tiles, X.float())
    with pytest.raises(ValueError, match="128x128"):
        spmm.spmm_symmetric(rows, cols, tiles[:, :32, :32].contiguous(),
                            X[:, :32 * TP.meta.nt].contiguous())
    with pytest.raises(ValueError, match="int32"):
        spmm.spmm_paired(pair[0].long(), pair[1], pair[2], X)
    with pytest.raises(ValueError, match="contiguous"):
        spmm.spmm_paired(*pair, X.t().contiguous().t())
    with pytest.raises(ValueError, match="2-row"):
        spmm.spmm_paired(*single, X)
    with pytest.raises(ValueError, match="1-row"):
        spmm.spmm_grouped(*pair, X)
    with pytest.raises(ValueError, match="different devices"):
        spmm.spmm_bucketed([(single[0], single[1], single[2].cpu())], X)
    assert spmm.launch_counts() == before
