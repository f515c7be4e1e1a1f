"""The sub-block layouts of the port's two redesigned SpMM kernels, on the
CPU, against the JAX package and against numpy.

Kernel 1 (``csrc/spmm_sym.cu``) reads Q as a block CSR over output strips
of B scalar columns (``spmm.build_output_csr``, ``StripCSR``); kernel 3
(``csrc/spmm_grouped.cu``) reads the row-group packs compacted to their
non-empty B x B sub-blocks (``spmm_pack.compact_buckets``, ``PairBlocks``),
B = ``spmm.BLOCK``.  Checked here:

* the compaction round trip: scattering the stored blocks back gives the
  dense tiles (random sparse tiles and graph tiles), and only non-empty
  blocks are stored;
* each layout's plain version (what apply_tiled runs on the CPU) against
  ``dcora_tpu.core.tiled.apply_tiled``'s XLA tile path at f64 (1e-12 of
  max|W|) and f32 (F32_ATOL), and against ``pallas_spmm.spmm_bucketed`` in
  interpret mode on the JAX build's own packs (f32), at r_pad 1, 8, 16;
* a numpy walk of each kernel's work assignment: strip -> entries in
  ascending source order; slot -> sub-blocks, forward K-fused over the
  group's rows, transposed unless c_j == r_1.  The walks reproduce the
  dense product, the kernels' tables list exactly the walks' work, and the
  wrong mask (also c_j == r_2) does not reproduce it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcora_tpu.core.tiled as jtiled
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


def _sparse_band(T=16, nt=11, seed=0, density=0.05):
    """An upper-triangular tile list on a band (every diagonal tile, the
    first off-diagonal, others with probability 0.6) whose tiles are mostly
    zero, as the pose graphs' are: entries non-zero with `density`,
    diagonal tiles symmetric."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(nt):
        for c in range(r, min(nt, r + 5)):
            if c <= r + 1 or rng.random() < 0.6:
                rows.append(r)
                cols.append(c)
    rows, cols = np.array(rows, np.int32), np.array(cols, np.int32)
    tiles = rng.standard_normal((len(rows), T, T)) * \
        (rng.random((len(rows), T, T)) < density)
    diag = rows == cols
    tiles[diag] = tiles[diag] + tiles[diag].transpose(0, 2, 1)
    return rows, cols, tiles


@pytest.fixture(scope="module")
def graph():
    """A random graph with every measurement type: the JAX graph, the
    port's, and the stored upper tiles of the JAX build at T = 32 (f64)."""
    rng = np.random.default_rng(21)
    gj, gt = build_graphs(random_graph_spec(rng, n=110, l=8, b=4))
    TP = jtiled.build_tiled(gj.problem_data(), gj.dims, T=32,
                            dtype=np.float64, with_pallas=False)
    trow, tcol = np.asarray(TP.Q.tile_rows), np.asarray(TP.Q.tile_cols)
    up = trow <= tcol
    return gj, gt, (trow[up], tcol[up], np.asarray(TP.Q.tiles)[up])


def _tile_lists(graph):
    return {"sparse band": _sparse_band(), "graph": graph[2]}


def _dense_upper(rows, cols, tiles, nt):
    """The stored tiles placed at their (row, col) tile positions."""
    T = tiles.shape[-1]
    D = np.zeros((nt * T, nt * T))
    for r, c, t in zip(rows, cols, tiles):
        D[r * T:(r + 1) * T, c * T:(c + 1) * T] = t
    return D


def _symmetric(rows, cols, tiles, nt):
    """The full symmetric Q of an upper tile list (diagonal tiles as
    stored, off-diagonal tiles mirrored)."""
    T = tiles.shape[-1]
    Q = np.zeros((nt * T, nt * T))
    for r, c, t in zip(rows, cols, tiles):
        Q[r * T:(r + 1) * T, c * T:(c + 1) * T] = t
        if r != c:
            Q[c * T:(c + 1) * T, r * T:(r + 1) * T] = t.T
    return Q


# --------------------------------------------------------------------------
# the compaction round trip
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("density", [0.02, 0.2])
def test_nonempty_blocks_matches_naive(density, dtype):
    B = spmm.BLOCK
    rng = np.random.default_rng(7)
    a = (rng.standard_normal((3, 4 * B, 6 * B)) *
         (rng.random((3, 4 * B, 6 * B)) < density)).astype(dtype)
    naive = np.abs(a.reshape(3, 4, B, 6, B)).sum(axis=(2, 4)) > 0
    np.testing.assert_array_equal(spmm.nonempty_blocks(a), naive)
    assert naive.any() and not naive.all()


@pytest.mark.parametrize("source", ["sparse band", "graph"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_strip_csr_round_trip(graph, dtype, source):
    """Scattering the strip CSR's blocks back gives the transpose of the Q
    that W = X Q applies (a diagonal tile A is applied as X A, and its
    rounding may leave it not exactly symmetric); each strip's sources
    ascend; no stored block is empty."""
    rows, cols, tiles = _tile_lists(graph)[source]
    tiles = tiles.astype(dtype)
    T, B = tiles.shape[-1], spmm.BLOCK
    nt = int(cols.max()) + 1
    ptr, src, vals = spmm.build_output_csr(rows, cols, tiles, nt)
    assert ptr.dtype == src.dtype == np.int32 and vals.dtype == tiles.dtype
    assert len(ptr) == nt * T // B + 1 and ptr[-1] == len(src) == len(vals)
    Q = np.zeros((nt * T, nt * T))
    for s in range(len(ptr) - 1):
        assert np.all(np.diff(src[ptr[s]:ptr[s + 1]]) > 0)
        for e in range(ptr[s], ptr[s + 1]):
            Q[s * B:(s + 1) * B, src[e] * B:(src[e] + 1) * B] = vals[e]
    np.testing.assert_array_equal(Q, _symmetric(rows, cols, tiles, nt).T)
    assert np.all(np.abs(vals).reshape(len(vals), -1).max(axis=1) > 0)


@pytest.mark.parametrize("source", ["sparse band", "graph"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pair_blocks_round_trip(graph, dtype, source):
    """Scattering the compacted paired packs back gives the stored tiles at
    their places; no stored block is empty; min_kpad is one past the last
    column reached.  (Which runs are masked is checked against the walk in
    test_slot_walk_and_mask_rule.)"""
    rows, cols, tiles = _tile_lists(graph)[source]
    tiles = tiles.astype(dtype)
    T, B = tiles.shape[-1], spmm.BLOCK
    nt = int(cols.max()) + 1
    buckets = spmm_pack.build_row_pairs_bucketed(rows, cols, tiles, T=T)
    run_ptr, run_col, ent_col, vals, min_kpad = \
        spmm_pack.compact_buckets(buckets)
    assert vals.dtype == tiles.dtype
    assert run_ptr[-1] == len(ent_col) == len(vals)
    last = np.flatnonzero(np.abs(_symmetric(rows, cols, tiles, nt)).sum(0))
    assert min_kpad == (last[-1] // B + 1) * B <= nt * T
    D = np.zeros((nt * T, nt * T))
    for r in range(len(run_col)):
        c = run_col[r] & ~1
        for e in range(run_ptr[r], run_ptr[r + 1]):
            D[ent_col[e]:ent_col[e] + B, c:c + B] = vals[e]
    np.testing.assert_array_equal(D, _dense_upper(rows, cols, tiles, nt))
    assert np.all(np.abs(vals).reshape(len(vals), -1).max(axis=1) > 0)
    # masked runs (c_j == r_1: the r_1 diagonal tile) read that tile only
    for r in np.flatnonzero(run_col & 1):
        c = (run_col[r] & ~1) // T
        assert set(ent_col[run_ptr[r]:run_ptr[r + 1]] // T) == {c}
    assert (run_col & 1).any() and not (run_col & 1).all()


def test_layouts_reject_tiles_that_do_not_split():
    rows, cols, tiles = _sparse_band(T=6, nt=3)
    with pytest.raises(ValueError, match="4x4"):
        spmm.build_output_csr(rows, cols, tiles, 3)
    with pytest.raises(ValueError, match="multiple of 4"):
        spmm_pack.compact_buckets(
            spmm_pack.build_row_pairs_bucketed(rows, cols, tiles, T=6))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_layouts_reject_an_x_they_do_not_fit(dtype):
    """An X narrower than the strip CSR's strips or the packs' reach is
    refused before anything is applied: on the card the kernels would
    write outside W."""
    rows, cols, tiles = _sparse_band()
    nt, T = int(cols.max()) + 1, tiles.shape[-1]
    strips = spmm.to_device(spmm.build_output_csr(rows, cols, tiles, nt),
                            dtype, "cpu")
    pairs = spmm.to_device(spmm_pack.compact_buckets(
        spmm_pack.build_row_pairs_bucketed(rows, cols, tiles, T=T)), dtype,
        "cpu")
    X = torch.ones((8, nt * T), dtype=dtype)
    assert pairs.min_kpad == nt * T
    for narrow in (X[:, :-T], X[:, :-spmm.BLOCK]):
        with pytest.raises(ValueError, match="do not index"):
            spmm.spmm_sym(strips, narrow)
        with pytest.raises(ValueError, match="reach column"):
            spmm.spmm_paired(pairs, narrow.contiguous())
    # a wider X takes the packs (its extra columns get no product)
    wide = torch.cat([X, X[:, :T]], 1)
    W = spmm.spmm_paired(pairs, wide)
    assert torch.equal(W[:, :nt * T], spmm.spmm_paired(pairs, X))
    assert not W[:, nt * T:].any()


# --------------------------------------------------------------------------
# the plain versions against the JAX package
# --------------------------------------------------------------------------


def _port_tiled(TPj, dtype, pack):
    """The JAX build carried across (convert.tiled_problem), with the
    paired packs compacted from the same upper tiles when `pack` is
    paired."""
    TPc = convert.tiled_problem(TPj, dtype=dtype)
    if pack == "paired":
        Q = TPc.Q
        TPc = dataclasses.replace(TPc, Q=Q._replace(pairs=spmm.to_device(
            spmm_pack.compact_buckets(spmm_pack.build_row_pairs_bucketed(
                np_of(Q.tile_rows), np_of(Q.tile_cols), np_of(Q.tiles),
                T=TPc.meta.T)), dtype, "cpu")))
    return TPc


def _layout_plain(TP, X, pack):
    Q = TP.Q
    if pack == "paired":
        return spmm.spmm_paired_plain(Q.pairs, X)
    return spmm.spmm_strips_plain(Q.strips, X)


@pytest.mark.parametrize("pack", ["bucketed", "paired"])
@pytest.mark.parametrize("r_pad", [1, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_versions_match_jax_apply_tiled(graph, dtype, r_pad, pack):
    gj = graph[0]
    jdt = np.float32 if dtype == torch.float32 else np.float64
    TPj = jtiled.build_tiled(gj.problem_data(), gj.dims, T=32, dtype=jdt,
                             with_pallas=False)
    TP = _port_tiled(TPj, dtype, pack)
    X = np.random.default_rng(r_pad).standard_normal((r_pad, TP.meta.kpad))
    ref = jtiled.apply_tiled(TPj, jnp.asarray(X, jdt))
    out = _layout_plain(TP, torch.as_tensor(X, dtype=dtype), pack)
    assert out.dtype == dtype
    assert_close(out, ref, rtol=F64_TOL if dtype == torch.float64
                 else F32_ATOL)


@pytest.mark.parametrize("pack", ["bucketed", "paired"])
@pytest.mark.parametrize("r_pad", [1, 8, 16])
def test_plain_versions_match_pallas_interpret(graph, monkeypatch, r_pad,
                                               pack):
    """f32, T = 128, against the TPU kernel on the JAX build's own packs
    (bucketed or paired, as DCORA_SPMM_PACK selects), in interpret mode."""
    gj = graph[0]
    monkeypatch.setenv("DCORA_SPMM_PACK", pack)
    TPj = jtiled.build_tiled(gj.problem_data(), gj.dims, dtype=np.float32,
                             with_pallas=True)
    TP = convert.tiled_problem(TPj)
    assert (TP.Q.pairs is not None) == (pack == "paired")
    X = np.random.default_rng(r_pad).standard_normal(
        (r_pad, TP.meta.kpad)).astype(np.float32)
    ref = pallas_spmm.spmm_bucketed(TPj.Q.grp_buckets, jnp.asarray(X),
                                    T=128, interpret=True)
    assert_close(_layout_plain(TP, torch.as_tensor(X), pack), ref,
                 rtol=F32_ATOL)


# --------------------------------------------------------------------------
# numpy walks of the kernels' work assignment
# --------------------------------------------------------------------------


def _walk_strips(strips, X):
    """csrc/spmm_sym.cu in numpy: one warp per output strip, its entries in
    ascending source order, each lane's column written once."""
    ptr, src, vals = strips
    B = spmm.BLOCK
    W = np.zeros_like(X)
    for s in range(len(ptr) - 1):
        acc = np.zeros((X.shape[0], B))
        for e in range(ptr[s], ptr[s + 1]):
            acc += X[:, src[e] * B:(src[e] + 1) * B] @ vals[e].T
        W[:, s * B:(s + 1) * B] = acc
    return W


def _walk_slots(buckets, X, mask_r2=False):
    """csrc/spmm_grouped.cu's assignment in numpy, from the wide packs: per
    slot (g, j) and sub-column b, the non-empty sub-blocks of the group's
    rows in (h, a) order; their forward products summed (the K-fusion) and
    added into W[:, c_j T + bB] once; each transposed product added into
    W[:, r_h T + aB] unless c_j == r_1 (or, with mask_r2, also c_j == r_2:
    the wrong rule).  Returns W and the work list [(column | mask, [entry
    columns])] in the order the kernel's table holds it."""
    B = spmm.BLOCK
    W, work = np.zeros_like(X), []
    for grows, gcols, wide in buckets:
        ng, G = gcols.shape
        T = wide.shape[2] // G
        R = wide.shape[1] // T
        grows = grows.reshape(ng, R)
        for g in range(ng):
            for j in range(G):
                c = int(gcols[g, j])
                masked = c == grows[g, 0] or (mask_r2 and c in grows[g])
                for b in range(T // B):
                    col = c * T + b * B
                    acc, ents = 0.0, []
                    for h in range(R):
                        for a in range(T // B):
                            A = wide[g, h * T + a * B:h * T + (a + 1) * B,
                                     j * T + b * B:j * T + (b + 1) * B]
                            if not A.any():
                                continue
                            e = int(grows[g, h]) * T + a * B
                            ents.append(e)
                            acc = acc + X[:, e:e + B] @ A
                            if not masked:
                                W[:, e:e + B] += X[:, col:col + B] @ A.T
                    if ents:
                        W[:, col:col + B] += acc
                        work.append((col | int(c == grows[g, 0]), ents))
    return W, work


@pytest.mark.parametrize("r_pad", [1, 8])
def test_strip_walk_reproduces_dense_product(graph, r_pad):
    rows, cols, tiles = graph[2]
    T = tiles.shape[-1]
    nt = int(cols.max()) + 1
    X = np.random.default_rng(r_pad).standard_normal((r_pad, nt * T))
    strips = spmm.build_output_csr(rows, cols, tiles, nt)
    ref = X @ _symmetric(rows, cols, tiles, nt)
    assert_close(_walk_strips(strips, X), ref, rtol=1e-13)


@pytest.mark.parametrize("source", ["sparse band", "graph"])
@pytest.mark.parametrize("r_pad", [1, 8])
def test_slot_walk_and_mask_rule(graph, r_pad, source):
    rows, cols, tiles = _tile_lists(graph)[source]
    T = tiles.shape[-1]
    nt = int(cols.max()) + 1
    buckets = spmm_pack.build_row_pairs_bucketed(rows, cols, tiles, T=T)
    assert any(np.any(gc == gr[:, 1:]) for gr, gc, _ in buckets
               if gr.ndim == 2)  # (r1, r2) tiles ride inside pairs
    X = np.random.default_rng(r_pad).standard_normal((r_pad, nt * T))
    ref = X @ _symmetric(rows, cols, tiles, nt)
    W, work = _walk_slots(buckets, X)
    assert_close(W, ref, rtol=1e-13)
    wrong, _ = _walk_slots(buckets, X, mask_r2=True)
    # far outside the walk's 1e-13 (the graph's (r1, r2) tiles can be
    # small against its largest entries)
    assert np.abs(wrong - ref).max() > 1e-6 * np.abs(ref).max()
    # the kernel's table lists exactly the walk's runs, in the same order
    run_ptr, run_col, ent_col, _, _ = spmm_pack.compact_buckets(buckets)
    assert [(int(c), [int(e) for e in ent_col[p:q]]) for c, p, q in
            zip(run_col, run_ptr[:-1], run_ptr[1:])] == work
