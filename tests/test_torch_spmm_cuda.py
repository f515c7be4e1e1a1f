"""The CUDA SpMM kernels on the card, against their plain PyTorch versions.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed.  Every test needs a CUDA device and skips without one; on the
card run it with

    python -m pytest --noconftest -m cuda tests/test_torch_spmm_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX).
Tolerances are relative to max|W|: 1e-12 in f64 and 1e-5 in f32, for a
different summation order (plus f32 rounding).  The owner-computes strip
kernel (spmm_sym) is deterministic and tested for it; the atomics kernels
(spmm_symmetric, spmm_paired) sum in no fixed order, so for them repeated
launches are held to the same tolerance instead.
"""

import pytest
import torch

from dcora_tpu_torch import datasets
from dcora_tpu_torch.core import spmm, spmm_pack, tiled
from dcora_tpu_torch.core.spmm import T_TILE
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
    S = TP.Q.strips
    assert S.src.shape[0] > 2 * TP.meta.nt and S.vals.shape[-1] == spmm.BLOCK
    X = _operand(TP, r_pad, live, dtype)
    before = spmm.spmm_sym.launches
    W = tiled.apply_tiled(TP, X)
    assert spmm.spmm_sym.launches == before + 1
    ref = spmm.spmm_sym_plain(TP.Q.tiles, TP.Q.tile_rows, TP.Q.tile_cols, X)
    plain = spmm.spmm_strips_plain(S, X)
    torch.cuda.synchronize()
    assert W.is_cuda and W.dtype == dtype and W.shape == X.shape
    assert _rel_err(W, plain) <= RTOL[dtype]
    assert _rel_err(W, ref) <= RTOL[dtype]
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
    S = TP.Q.strips
    X = _operand(TP, 8, 8, torch.float64)
    before = spmm.spmm_sym.launches
    with pytest.raises(ValueError, match="int32"):
        spmm.spmm_sym(S._replace(ptr=S.ptr.long()), X)
    with pytest.raises(ValueError, match="contiguous"):
        spmm.spmm_sym(S, X.t().contiguous().t())
    with pytest.raises(ValueError, match="different devices"):
        spmm.spmm_sym(S._replace(vals=S.vals.cpu()), X)
    with pytest.raises(ValueError, match="sub-blocks"):
        spmm.spmm_sym(S._replace(vals=S.vals[:, :2, :2].contiguous()), X)
    with pytest.raises(ValueError, match="do not index"):
        spmm.spmm_sym(S, X[:, :-T_TILE].contiguous())
    assert spmm.spmm_sym.launches == before


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
    """apply_tiled on a paired build: the two-row packs and their leftover
    buckets, compacted, in one launch."""
    TP = _tiled(problem, dtype, pack="paired")
    Pb = TP.Q.pairs
    assert Pb.vals.shape[-1] == spmm.BLOCK
    masked = (Pb.run_col & 1).bool()
    assert masked.any() and not masked.all()
    X = _operand(TP, r_pad, live, dtype)
    before = spmm.launch_counts()
    W = tiled.apply_tiled(TP, X)
    after = spmm.launch_counts()
    assert after["spmm_paired"] == before["spmm_paired"] + 1
    assert {k: v for k, v in after.items() if k != "spmm_paired"} == \
        {k: v for k, v in before.items() if k != "spmm_paired"}
    plain = spmm.spmm_paired_plain(Pb, X)
    ref_sym = spmm.spmm_sym_plain(TP.Q.tiles, TP.Q.tile_rows, TP.Q.tile_cols,
                                  X)
    torch.cuda.synchronize()
    assert W.is_cuda and W.dtype == dtype and W.shape == X.shape
    assert _rel_err(W, plain) <= RTOL[dtype]
    assert _rel_err(W, ref_sym) <= RTOL[dtype]
    assert not W[live:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("G", [2, 8])
def test_grouped_kernel_matches_plain_on_card(problem, dtype, G):
    """Single-row groups (the fixed-G layout, zero pad slots at col ==
    row), compacted, through the same kernel."""
    TP = _tiled(problem, dtype)
    Q = TP.Q
    Pb = spmm.to_device(spmm_pack.compact_buckets([spmm_pack.build_row_groups(
        Q.tile_rows.cpu().numpy(), Q.tile_cols.cpu().numpy(),
        Q.tiles.cpu().numpy(), T=128, G=G)]), dtype, "cuda")
    X = _operand(TP, 8, 8, dtype)
    before = spmm.spmm_paired.launches
    W = spmm.spmm_paired(Pb, X)
    assert spmm.spmm_paired.launches == before + 1
    ref = spmm.spmm_paired_plain(Pb, X)
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
    Pb = TP.Q.pairs
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
        spmm.spmm_paired(Pb._replace(ent_col=Pb.ent_col.long()), X)
    with pytest.raises(ValueError, match="contiguous"):
        spmm.spmm_paired(Pb, X.t().contiguous().t())
    with pytest.raises(TypeError):
        spmm.spmm_paired(Pb, X.float())
    with pytest.raises(ValueError, match="do not index"):
        spmm.spmm_paired(Pb._replace(run_ptr=Pb.run_ptr[:-1]), X)
    with pytest.raises(ValueError, match="different devices"):
        spmm.spmm_paired(Pb._replace(vals=Pb.vals.cpu()), X)
    with pytest.raises(ValueError, match="sub-blocks"):
        spmm.spmm_paired(Pb._replace(vals=Pb.vals[:, :2, :2].contiguous()), X)
    with pytest.raises(ValueError, match="reach column"):
        spmm.spmm_paired(Pb, X[:, :-T_TILE].contiguous())
    assert spmm.launch_counts() == before
