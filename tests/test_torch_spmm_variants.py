"""The port's packers and the plain versions of its per-tile (spmm_symmetric)
and grouped (spmm_paired, on the packs compacted by
spmm_pack.compact_buckets) SpMM kernels against the JAX package, on the
same numpy inputs.

* spmm_pack's five packers give arrays equal to pallas_spmm's at f32, on a
  tile list with (r1, r2) tiles inside row pairs and (r2, r2) diagonals;
* spmm_paired's plain version on the compacted packs agrees with the Pallas
  grouped / paired kernels in interpret mode (as tests/test_tiled.py runs
  them) on the same packs, at T = 32 and 128;
* spmm_symmetric's plain version, on the per-tile list compacted by
  spmm.compact_tiles, agrees with JAX's apply_tiled (XLA path;
  tests/test_torch_spmm_tiles.py holds it against the Pallas kernel in
  interpret mode); the CUDA kernels themselves have no interpret mode and
  no JAX test (tests/test_torch_spmm_cuda.py holds them against these
  plain versions on the card);
* a numpy walk of the packs' slots, with their mask rule (c == r1 only),
  reproduces the dense product, and the rule that also masks c == r2 does
  not (tests/test_torch_spmm_blocks.py walks the compacted sub-blocks).

Tolerances: 1e-12 of max|W| in f64, F32_ATOL (2e-6) in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcora_tpu.core.tiled as jtiled
import dcora_tpu_torch.core.tiled as ttiled
from dcora_tpu.core import pallas_spmm
from dcora_tpu_torch import convert
from dcora_tpu_torch.core import spmm, spmm_pack
from torch_port_common import (
    F32_ATOL,
    assert_close,
    build_graphs,
    np_of,
    random_graph_spec,
)

F64_TOL = 1e-12


def _compact(buckets, dtype):
    """numpy packs -> the grouped kernel's PairBlocks on the CPU."""
    return spmm.to_device(spmm_pack.compact_buckets(buckets), dtype, "cpu")


def _band_list(T=16, nt=13, seed=0, dtype=np.float32):
    """An upper-triangular tile list on an RCM-like band: every diagonal
    tile (so every pair has an (r2, r2) diagonal), and off-diagonal tiles
    up to 4 columns right with probability 0.6 (so pairs share and miss
    columns, and (r1, r1 + 1) tiles exist).  Diagonal tiles symmetric."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(nt):
        for c in range(r, min(nt, r + 5)):
            if c == r or c == r + 1 or rng.random() < 0.6:
                rows.append(r)
                cols.append(c)
    rows, cols = np.array(rows, np.int32), np.array(cols, np.int32)
    tiles = rng.standard_normal((len(rows), T, T))
    diag = rows == cols
    tiles[diag] = tiles[diag] + tiles[diag].transpose(0, 2, 1)
    return rows, cols, tiles.astype(dtype)


def _dense(rows, cols, tiles, nt):
    T = tiles.shape[-1]
    Q = np.zeros((nt * T, nt * T))
    for r, c, t in zip(rows, cols, tiles):
        Q[r * T:(r + 1) * T, c * T:(c + 1) * T] = t
        if r != c:
            Q[c * T:(c + 1) * T, r * T:(r + 1) * T] = t.T
    return Q


def _assert_buckets_equal(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def graph_tiles():
    """The stored upper tiles of a random graph with every measurement type
    (JAX build, f32) at T = 32 and T = 128."""
    rng = np.random.default_rng(7)
    gj, _ = build_graphs(random_graph_spec(rng, n=110, l=8, b=4))
    Pj = gj.problem_data()
    out = {}
    for T in (32, 128):
        TP = jtiled.build_tiled(Pj, gj.dims, T=T, dtype=np.float32,
                                with_pallas=False)
        trow, tcol = np.asarray(TP.Q.tile_rows), np.asarray(TP.Q.tile_cols)
        up = trow <= tcol
        out[T] = (TP, trow[up], tcol[up], np.asarray(TP.Q.tiles)[up])
    return out


# --------------------------------------------------------------------------
# the packers, array for array
# --------------------------------------------------------------------------


@pytest.mark.parametrize("G", [1, 3, 8])
def test_build_row_groups_matches_jax(G):
    rows, cols, tiles = _band_list()
    port = spmm_pack.build_row_groups(rows, cols, tiles, T=16, G=G)
    ref = pallas_spmm.build_row_groups(rows, cols, tiles, T=16, G=G)
    _assert_buckets_equal([port], [ref])


def test_row_partition_widths_and_bucket_widths_match_jax():
    rng = np.random.default_rng(1)
    for counts in ([1], [3, 3, 3, 4], list(rng.integers(1, 20, 200)),
                   list(rng.integers(4, 7, 50))):
        assert spmm_pack.choose_bucket_widths(counts) == \
            pallas_spmm.choose_bucket_widths(counts)
        for widths in ((8,), (1, 4), (3, 5, 7)):
            hist = {int(t): 1 for t in counts}
            assert spmm_pack._row_partition_widths(hist, widths, 0.75) == \
                pallas_spmm._row_partition_widths(hist, widths, 0.75)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_row_groups_bucketed_matches_jax(seed):
    rows, cols, tiles = _band_list(seed=seed)
    _assert_buckets_equal(
        spmm_pack.build_row_groups_bucketed(rows, cols, tiles, T=16),
        pallas_spmm.build_row_groups_bucketed(rows, cols, tiles, T=16))


@pytest.mark.parametrize("seed", [0, 1])
def test_build_row_pairs_bucketed_matches_jax(seed):
    rows, cols, tiles = _band_list(seed=seed)
    port = spmm_pack.build_row_pairs_bucketed(rows, cols, tiles, T=16)
    _assert_buckets_equal(
        port, pallas_spmm.build_row_pairs_bucketed(rows, cols, tiles, T=16))
    pairs = [b for b in port if b[0].ndim == 2]
    leftovers = [b for b in port if b[0].ndim == 1]
    assert pairs and leftovers
    # (r1, r2) tiles ride inside pairs; (r2, r2) diagonals are leftovers
    assert any(np.any(gc == gr[:, 1:]) for gr, gc, _ in pairs)
    assert any(np.any((gc == gr[:, None]) & (gr[:, None] % 2 == 1))
               for gr, gc, _ in leftovers)


def test_packers_on_graph_tiles_match_jax(graph_tiles):
    _, rows, cols, tiles = graph_tiles[32]
    for name in ("build_row_groups_bucketed", "build_row_pairs_bucketed"):
        _assert_buckets_equal(
            getattr(spmm_pack, name)(rows, cols, tiles, T=32),
            getattr(pallas_spmm, name)(rows, cols, tiles, T=32))


def test_packers_keep_the_tile_dtype():
    """The deliberate difference: f64 tiles give f64 wide buffers, equal to
    JAX's f32 ones once rounded."""
    rows, cols, tiles = _band_list(dtype=np.float64)
    for name in ("build_row_groups_bucketed", "build_row_pairs_bucketed"):
        port = getattr(spmm_pack, name)(rows, cols, tiles, T=16)
        ref = getattr(pallas_spmm, name)(rows, cols, tiles, T=16)
        assert all(b[2].dtype == np.float64 for b in port)
        _assert_buckets_equal([(a, b, c.astype(np.float32))
                               for a, b, c in port], ref)
    gr, gc, gw = spmm_pack.build_row_groups(rows, cols, tiles, T=16, G=4)
    assert gw.dtype == np.float64


# --------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret) and JAX's XLA path
# --------------------------------------------------------------------------


@pytest.mark.parametrize("T", [32, 128])
def test_paired_plain_matches_pallas_interpret(graph_tiles, T):
    TP, rows, cols, tiles = graph_tiles[T]
    buckets = spmm_pack.build_row_pairs_bucketed(rows, cols, tiles, T=T)
    assert any(b[2].shape[1] == 2 * T for b in buckets)
    rng = np.random.default_rng(T)
    X = rng.standard_normal((8, TP.meta.kpad)).astype(np.float32)
    ref = pallas_spmm.spmm_bucketed(
        [tuple(jnp.asarray(a) for a in b) for b in buckets], jnp.asarray(X),
        T=T, interpret=True)
    Xt = torch.as_tensor(X)
    assert_close(spmm.spmm_paired(_compact(buckets, torch.float32), Xt),
                 ref, rtol=F32_ATOL)
    # the two-row buckets alone, against the paired kernel alone
    for gr, gc, gw in buckets:
        if gr.ndim != 2:
            continue
        ref = pallas_spmm.spmm_paired(
            jnp.asarray(gr), jnp.asarray(gc), jnp.asarray(gw),
            jnp.asarray(X), T=T, G=gc.shape[1], interpret=True)
        assert_close(spmm.spmm_paired(
                         _compact([(gr, gc, gw)], torch.float32), Xt), ref,
                     rtol=F32_ATOL,
                     scale=float(np.abs(np.asarray(ref)).max()) + 1e-30)


@pytest.mark.parametrize("G", [2, 8])
def test_grouped_plain_matches_pallas_interpret(graph_tiles, G):
    TP, rows, cols, tiles = graph_tiles[32]
    gr, gc, gw = spmm_pack.build_row_groups(rows, cols, tiles, T=32, G=G)
    rng = np.random.default_rng(G)
    X = rng.standard_normal((8, TP.meta.kpad)).astype(np.float32)
    ref = pallas_spmm.spmm_grouped(jnp.asarray(gr), jnp.asarray(gc),
                                   jnp.asarray(gw), jnp.asarray(X), T=32, G=G,
                                   interpret=True)
    assert_close(spmm.spmm_paired(_compact([(gr, gc, gw)], torch.float32),
                                  torch.as_tensor(X)), ref, rtol=F32_ATOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r_pad", [1, 8])
def test_symmetric_plain_matches_jax_apply_tiled(dtype, r_pad):
    """spmm_symmetric (its plain version on the CPU) on the per-tile list,
    padded to 8-tile chunks with zero tiles at (0, 0) and compacted to its
    non-empty sub-blocks, against JAX's XLA tile path."""
    rng = np.random.default_rng(3)
    gj, gt = build_graphs(random_graph_spec(rng, n=40, l=9, b=6))
    jdt = np.float32 if dtype == torch.float32 else np.float64
    TPj = jtiled.build_tiled(gj.problem_data(), gj.dims, T=32, dtype=jdt,
                             with_pallas=False)
    TPt = ttiled.build_tiled(gt.problem_data(), gt.dims, T=32, dtype=dtype)
    Q = TPt.Q
    pad = -Q.tiles.shape[0] % 8
    rows = torch.cat([Q.tile_rows, Q.tile_rows.new_zeros(pad)]).int()
    cols = torch.cat([Q.tile_cols, Q.tile_cols.new_zeros(pad)]).int()
    tiles = torch.cat([Q.tiles, Q.tiles.new_zeros((pad, 32, 32))])
    blocks = spmm.to_device(spmm.compact_tiles(rows, cols, tiles), dtype,
                            "cpu")
    assert blocks.tile_row.shape[0] == Q.tiles.shape[0]  # pads dropped
    X = rng.standard_normal((r_pad, TPt.meta.kpad))
    ref = jtiled.apply_tiled(TPj, jnp.asarray(X, jdt))
    before = spmm.spmm_symmetric.launches
    out = spmm.spmm_symmetric(blocks, torch.as_tensor(X, dtype=dtype))
    assert spmm.spmm_symmetric.launches == before  # the plain path
    assert out.dtype == dtype
    assert_close(out, ref, rtol=F64_TOL if dtype == torch.float64
                 else F32_ATOL)


# --------------------------------------------------------------------------
# the CUDA grouped kernel's traversal and mask rule, in numpy
# --------------------------------------------------------------------------


def _walk_grouped_kernel(buckets, X, mask_r2=False):
    """The packs' slots in numpy, at tile level: per slot (g, j), the
    forward product summed over the group's rows into W[:, c_j], the
    transposed one into W[:, r_h] unless c_j == r_1 (or, with mask_r2,
    also c_j == r_2: the wrong rule)."""
    W = np.zeros_like(X)
    for grows, gcols, wide in buckets:
        ng, G = gcols.shape
        T = wide.shape[2] // G
        R = wide.shape[1] // T
        grows = grows.reshape(ng, R)
        for g in range(ng):
            for j in range(G):
                c = gcols[g, j]
                masked = c == grows[g, 0] or (mask_r2 and R == 2
                                              and c == grows[g, 1])
                acc = 0.0
                for h in range(R):
                    r = grows[g, h]
                    A = wide[g, h * T:(h + 1) * T, j * T:(j + 1) * T]
                    acc = acc + X[:, r * T:(r + 1) * T] @ A
                    if not masked:
                        W[:, r * T:(r + 1) * T] += X[:, c * T:(c + 1) * T] @ A.T
                W[:, c * T:(c + 1) * T] += acc
    return W


def test_grouped_kernel_walk_and_mask_rule():
    rows, cols, tiles = _band_list(dtype=np.float64)
    nt, T = 13, 16
    buckets = spmm_pack.build_row_pairs_bucketed(rows, cols, tiles, T=T)
    X = np.random.default_rng(2).standard_normal((8, nt * T))
    ref = X @ _dense(rows, cols, tiles, nt)
    assert_close(_walk_grouped_kernel(buckets, X), ref, rtol=F64_TOL)
    wrong = _walk_grouped_kernel(buckets, X, mask_r2=True)
    assert np.abs(wrong - ref).max() > 1e-3 * np.abs(ref).max()
    # and the plain version, in f64, on the same buckets compacted
    assert_close(spmm.spmm_paired(_compact(buckets, torch.float64),
                                  torch.as_tensor(X)), ref, rtol=F64_TOL)


# --------------------------------------------------------------------------
# the packing switch of build_tiled, and convert
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_graphs():
    rng = np.random.default_rng(3)
    gj, gt = build_graphs(random_graph_spec(rng, n=40, l=9, b=6))
    return gj, gt, gj.problem_data(), gt.problem_data()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_build_tiled_paired_pack(small_graphs, monkeypatch, dtype):
    _, gt, _, Pt = small_graphs
    TPc = ttiled.build_tiled(Pt, gt.dims, T=32, dtype=dtype, pack="bucketed")
    TPp = ttiled.build_tiled(Pt, gt.dims, T=32, dtype=dtype, pack="paired")
    monkeypatch.setenv("DCORA_SPMM_PACK", "paired")
    TPe = ttiled.build_tiled(Pt, gt.dims, T=32, dtype=dtype)
    assert TPc.Q.pairs is None
    assert TPp.Q.pairs is not None and TPe.Q.pairs is not None
    Pb = TPp.Q.pairs
    assert Pb.vals.dtype == dtype and Pb.vals.shape[-1] == spmm.BLOCK
    assert {a.dtype for a in Pb[:3]} == {torch.int32}
    # the tile list and the strip CSR stay
    for name in ("tiles", "tile_rows", "tile_cols"):
        assert torch.equal(getattr(TPp.Q, name), getattr(TPc.Q, name))
    for a, b in zip(TPp.Q.strips, TPc.Q.strips):
        assert torch.equal(a, b)
    X = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (8, TPc.meta.kpad)), dtype=dtype)
    tol = F64_TOL if dtype == torch.float64 else F32_ATOL
    assert_close(ttiled.apply_tiled(TPp, X), ttiled.apply_tiled(TPc, X),
                 rtol=tol)
    assert_close(ttiled.apply_tiled(TPe, X), ttiled.apply_tiled(TPc, X),
                 rtol=tol)


def test_convert_carries_paired_buckets(small_graphs, monkeypatch):
    """A paired JAX build converts with its buckets (compacted), the port's
    own paired build makes the same ones, and both apply as the Pallas
    kernel does."""
    gj, gt, Pj, Pt = small_graphs
    monkeypatch.setenv("DCORA_SPMM_PACK", "paired")
    TPj = jtiled.build_tiled(Pj, gj.dims, dtype=np.float32, with_pallas=True)
    TPc = convert.tiled_problem(TPj)
    TPt = ttiled.build_tiled(Pt, gt.dims, dtype=torch.float32)
    assert TPc.Q.pairs is not None
    assert TPc.Q.pairs.min_kpad == TPt.Q.pairs.min_kpad
    for x, y in zip(TPc.Q.pairs[:4], TPt.Q.pairs[:4]):
        assert torch.equal(x, y)
    X = np.random.default_rng(5).standard_normal(
        (8, TPt.meta.kpad)).astype(np.float32)
    ref = pallas_spmm.spmm_bucketed(TPj.Q.grp_buckets, jnp.asarray(X),
                                    T=128, interpret=True)
    assert_close(ttiled.apply_tiled(TPc, torch.as_tensor(X)), ref,
                 rtol=F32_ATOL)
    # a bucketed (not paired) JAX build carries no buckets across
    monkeypatch.setenv("DCORA_SPMM_PACK", "bucketed")
    TPb = jtiled.build_tiled(Pj, gj.dims, dtype=np.float32, with_pallas=True)
    assert convert.tiled_problem(TPb).Q.pairs is None


# --------------------------------------------------------------------------
# what the wrappers refuse
# --------------------------------------------------------------------------


def test_wrappers_reject_what_the_kernels_do_not_take():
    rows, cols, tiles = _band_list(dtype=np.float64)
    nt, T = 13, 16
    Pb = _compact(spmm_pack.build_row_pairs_bucketed(rows, cols, tiles, T=T),
                  torch.float64)
    X = torch.zeros((8, nt * T), dtype=torch.float64)
    Tb = spmm.to_device(spmm.compact_tiles(rows, cols, tiles), torch.float64,
                        "cpu")
    before = spmm.launch_counts()
    with pytest.raises(TypeError):
        spmm.spmm_symmetric(Tb, X.float())
    with pytest.raises(ValueError):
        spmm.spmm_symmetric(Tb, X[:, :-1])
    with pytest.raises(ValueError, match="do not index"):
        spmm.spmm_symmetric(Tb._replace(tile_ptr=Tb.tile_ptr[:-1]), X)
    with pytest.raises(ValueError, match=r"\[ne, B, B\]"):
        spmm.spmm_symmetric(Tb._replace(vals=Tb.vals[:, :, :2]), X)
    with pytest.raises(ValueError, match="upper-triangular"):
        spmm.compact_tiles(cols, rows, tiles)
    with pytest.raises(TypeError):
        spmm.spmm_paired(Pb, X.float())
    with pytest.raises(ValueError, match="do not index"):
        spmm.spmm_paired(Pb._replace(run_ptr=Pb.run_ptr[:-1]), X)
    with pytest.raises(ValueError, match=r"\[ne, B, B\]"):
        spmm.spmm_paired(Pb._replace(vals=Pb.vals[:, :, :2]), X)
    with pytest.raises(ValueError, match="no buckets"):
        spmm_pack.compact_buckets([])
    # a tensor on any device other than the CPU never takes the plain path
    with pytest.raises(ValueError, match="unsupported device"):
        spmm.spmm_symmetric(spmm.to_device(Tb, torch.float64, "meta"),
                            X.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        spmm.spmm_paired(spmm.to_device(Pb, torch.float64, "meta"),
                         X.to("meta"))
    spmm.spmm_symmetric(Tb, X)
    spmm.spmm_paired(Pb, X)
    assert spmm.launch_counts() == before  # the plain paths launch none
