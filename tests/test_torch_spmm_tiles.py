"""Kernel 2's layout (``spmm.compact_tiles``, ``TileBlocks``) and its plain
version on the CPU, against the TPU kernel, the JAX package and numpy.

Kernel 2 (``csrc/spmm_tile.cu``, wrapper ``spmm.spmm_symmetric``) reads the
upper-triangular per-tile list cut down to each tile's non-empty B x B
sub-blocks (B = ``spmm.BLOCK``).  Checked here:

* the compaction round trip: scattering the entries back gives the stored
  tiles exactly (f32 and f64), zero tiles and empty blocks are dropped, a
  tile's entries are sorted by b, then a; the list padded to whole chunks
  with zero tiles at (0, 0), as the TPU kernel takes it, gives the same
  layout as the unpadded one; min_kpad is one past the last column reached;
* the plain version against ``pallas_spmm._spmm_kernel`` itself, run in
  interpret mode through this file's own ``pallas_call`` (the package's
  wrapper takes no ``interpret`` argument), f32 at T = 32 and 128 and
  r_pad 1, 8, 16 (F32_ATOL); and against ``dcora_tpu.core.tiled
  .apply_tiled``'s XLA tile path at f64 (1e-12 of max|W|) and f32;
* the kernel's summation order (``TileBlocks``' output CSR of (block,
  side) items) holds every block once forward and every block of an
  off-diagonal tile once transposed, each item in the strip it feeds,
  forward before transposed, in tile order and inside a tile by a
  (forward) or b (transposed);
* a numpy walk of that CSR (per output strip, its items in order)
  reproduces the dense product and spmm_symmetric_plain (1e-13 at f64);
  the same walk with the transposed product applied on diagonal tiles too
  does not;
* the wrapper refuses an X narrower than min_kpad.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import dcora_tpu.core.tiled as jtiled
from dcora_tpu.core import pallas_spmm
from dcora_tpu_torch.core import spmm
from torch_port_common import (
    F32_ATOL,
    assert_close,
    build_graphs,
    random_graph_spec,
)

F64_TOL = 1e-12


def _sparse_band(T=16, nt=11, seed=0, density=0.05):
    """An upper-triangular tile list on a band whose tiles are mostly zero,
    as the pose graphs' are (diagonal tiles symmetric), with one stored
    tile that is zero throughout."""
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
    tiles[np.flatnonzero(~diag)[1]] = 0.0
    return rows, cols, tiles


@pytest.fixture(scope="module")
def graph():
    """A random graph with every measurement type: the JAX graph and the
    stored upper tiles of its f64 JAX build at T = 32 and T = 128."""
    rng = np.random.default_rng(21)
    gj, _ = build_graphs(random_graph_spec(rng, n=110, l=8, b=4))
    out = {"graph": gj}
    for T in (32, 128):
        TP = jtiled.build_tiled(gj.problem_data(), gj.dims, T=T,
                                dtype=np.float64, with_pallas=False)
        trow, tcol = np.asarray(TP.Q.tile_rows), np.asarray(TP.Q.tile_cols)
        up = trow <= tcol
        out[T] = (trow[up], tcol[up], np.asarray(TP.Q.tiles)[up])
    return out


def _tile_lists(graph):
    return {"sparse band": _sparse_band(), "graph": graph[32]}


def _padded(rows, cols, tiles, chunk=pallas_spmm.CHUNK):
    """The list padded to whole chunks with zero tiles at (0, 0), as
    pallas_spmm.spmm_symmetric's caller pads it."""
    pad = -len(rows) % chunk
    return (np.concatenate([rows, np.zeros(pad, np.int32)]),
            np.concatenate([cols, np.zeros(pad, np.int32)]),
            np.concatenate([tiles, np.zeros((pad,) + tiles.shape[1:],
                                            tiles.dtype)]))


def _symmetric(rows, cols, tiles, nt):
    """The full Q of an upper tile list that W = X Q applies (diagonal
    tiles as stored, off-diagonal tiles mirrored)."""
    T = tiles.shape[-1]
    Q = np.zeros((nt * T, nt * T))
    for r, c, t in zip(rows, cols, tiles):
        Q[r * T:(r + 1) * T, c * T:(c + 1) * T] = t
        if r != c:
            Q[c * T:(c + 1) * T, r * T:(r + 1) * T] = t.T
    return Q


def _plain(rows, cols, tiles, X, dtype):
    blocks = spmm.to_device(spmm.compact_tiles(rows, cols, tiles), dtype,
                            "cpu")
    return spmm.spmm_symmetric(blocks, torch.as_tensor(X, dtype=dtype))


# --------------------------------------------------------------------------
# the layout
# --------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["sparse band", "graph"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_compact_tiles_round_trip(graph, dtype, source):
    rows, cols, tiles = _tile_lists(graph)[source]
    tiles = tiles.astype(dtype)
    T, B = tiles.shape[-1], spmm.BLOCK
    TB = T // B
    tile_ptr, tile_row, tile_col, ent_blk, vals, T_ = \
        spmm.compact_tiles(rows, cols, tiles)[:6]
    assert T_ == T and vals.dtype == tiles.dtype
    assert {a.dtype for a in (tile_ptr, tile_row, tile_col, ent_blk)} == \
        {np.dtype(np.int32)}
    live = np.abs(tiles).reshape(len(tiles), -1).max(axis=1) > 0
    if source == "sparse band":
        assert not live.all()
    np.testing.assert_array_equal(tile_row, rows[live])
    np.testing.assert_array_equal(tile_col, cols[live])
    assert tile_ptr[0] == 0 and tile_ptr[-1] == len(ent_blk) == len(vals)
    rebuilt = np.zeros_like(tiles[live])
    for t in range(len(tile_row)):
        blk = ent_blk[tile_ptr[t]:tile_ptr[t + 1]]
        a, b = blk // TB, blk % TB
        assert len(blk) and np.all(np.diff(b * TB + a) > 0)  # by b, then a
        for e, (aa, bb) in enumerate(zip(a, b), start=tile_ptr[t]):
            rebuilt[t, aa * B:(aa + 1) * B, bb * B:(bb + 1) * B] = vals[e]
    np.testing.assert_array_equal(rebuilt, tiles[live])
    assert np.all(np.abs(vals).reshape(len(vals), -1).max(axis=1) > 0)


@pytest.mark.parametrize("source", ["sparse band", "graph"])
def test_padded_and_unpadded_lists_give_the_same_layout(graph, source):
    rows, cols, tiles = _tile_lists(graph)[source]
    padded = _padded(rows, cols, tiles)
    assert len(padded[0]) % pallas_spmm.CHUNK == 0
    assert len(padded[0]) > len(rows)
    for x, y in zip(spmm.compact_tiles(*padded),
                    spmm.compact_tiles(rows, cols, tiles)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("source", ["sparse band", "graph"])
def test_min_kpad_is_one_past_the_last_column_reached(graph, source):
    rows, cols, tiles = _tile_lists(graph)[source]
    T, B = tiles.shape[-1], spmm.BLOCK
    nt = int(cols.max()) + 1
    last = np.flatnonzero(np.abs(_symmetric(rows, cols, tiles, nt)).sum(0))
    min_kpad = spmm.compact_tiles(rows, cols, tiles).min_kpad
    assert isinstance(min_kpad, int)
    assert min_kpad == (last[-1] // B + 1) * B <= nt * T
    # a list whose last tile column holds only a zero tile reaches no further
    zero = np.zeros((1, T, T), tiles.dtype)
    assert spmm.compact_tiles(np.append(rows, nt), np.append(cols, nt),
                              np.concatenate([tiles, zero])).min_kpad == \
        min_kpad


def test_compact_tiles_rejects_tiles_that_do_not_split():
    rows, cols, tiles = _sparse_band(T=6, nt=3)
    with pytest.raises(ValueError, match="4x4"):
        spmm.compact_tiles(rows, cols, tiles)


# --------------------------------------------------------------------------
# the plain version against the TPU kernel and JAX's XLA path
# --------------------------------------------------------------------------


def _pallas_spmm_kernel(rows, cols, tiles, X):
    """pallas_spmm._spmm_kernel itself, in interpret mode, called as
    pallas_spmm.spmm_symmetric calls it (f32, the list a whole number of
    chunks)."""
    m, T = tiles.shape[0], tiles.shape[-1]
    assert m % pallas_spmm.CHUNK == 0
    return pl.pallas_call(
        functools.partial(pallas_spmm._spmm_kernel, T=T, m=m),
        out_shape=jax.ShapeDtypeStruct(X.shape, X.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(rows), jnp.asarray(cols),
                        jnp.asarray(X), jnp.asarray(tiles))


@pytest.mark.parametrize("r_pad", [1, 8, 16])
@pytest.mark.parametrize("T", [32, 128])
def test_plain_matches_pallas_spmm_kernel_interpret(graph, T, r_pad):
    rows, cols, tiles = _padded(*graph[T])
    tiles = tiles.astype(np.float32)
    nt = int(cols.max()) + 1
    X = np.random.default_rng(T + r_pad).standard_normal(
        (r_pad, nt * T)).astype(np.float32)
    ref = _pallas_spmm_kernel(rows, cols, tiles, X)
    assert_close(_plain(rows, cols, tiles, X, torch.float32), ref,
                 rtol=F32_ATOL)


@pytest.mark.parametrize("r_pad", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_matches_jax_apply_tiled_at_t128(graph, dtype, r_pad):
    gj = graph["graph"]
    jdt = np.float32 if dtype == torch.float32 else np.float64
    TPj = jtiled.build_tiled(gj.problem_data(), gj.dims, T=128, dtype=jdt,
                             with_pallas=False)
    trow, tcol = np.asarray(TPj.Q.tile_rows), np.asarray(TPj.Q.tile_cols)
    up = trow <= tcol
    X = np.random.default_rng(r_pad).standard_normal((r_pad, TPj.meta.kpad))
    ref = jtiled.apply_tiled(TPj, jnp.asarray(X, jdt))
    out = _plain(*_padded(trow[up], tcol[up], np.asarray(TPj.Q.tiles)[up]),
                 X, dtype)
    assert out.dtype == dtype
    assert_close(out, ref, rtol=F64_TOL if dtype == torch.float64
                 else F32_ATOL)


# --------------------------------------------------------------------------
# a numpy walk of the kernel's work order
# --------------------------------------------------------------------------


def _walk_tiles(blocks, X, transpose_diagonal=False):
    """csrc/spmm_tile.cu's walk in numpy: per output strip s, its items in
    the CSR's order, a forward item (bit 0 of out_src clear) as the strip
    of X at out_src times the block, a transposed one as that strip times
    the block's transpose; each strip written once.  With
    transpose_diagonal the diagonal tiles' transposed products are added
    too (the wrong rule).  Returns W and the number of items."""
    (_, tile_row, tile_col, ent_blk, vals, T, _, out_ptr, out_ent,
     out_src) = blocks
    B = spmm.BLOCK
    TB = T // B
    W = np.zeros_like(X)
    for s in range(len(out_ptr) - 1):
        acc = np.zeros((X.shape[0], B))
        for e, src in zip(out_ent[out_ptr[s]:out_ptr[s + 1]],
                          out_src[out_ptr[s]:out_ptr[s + 1]]):
            col = src & ~1
            blk = vals[e].T if src & 1 else vals[e]
            acc = acc + X[:, col:col + B] @ blk
        W[:, s * B:(s + 1) * B] = acc
    if transpose_diagonal:
        for t in np.flatnonzero(tile_row == tile_col):
            r = int(tile_row[t])
            for e in range(blocks.tile_ptr[t], blocks.tile_ptr[t + 1]):
                a, b = divmod(int(ent_blk[e]), TB)
                W[:, r * T + a * B:r * T + (a + 1) * B] += \
                    X[:, r * T + b * B:r * T + (b + 1) * B] @ vals[e].T
    return W, len(out_ent)


@pytest.mark.parametrize("source", ["sparse band", "graph"])
@pytest.mark.parametrize("r_pad", [1, 8])
def test_tile_walk_reproduces_dense_product(graph, r_pad, source):
    rows, cols, tiles = _tile_lists(graph)[source]
    T = tiles.shape[-1]
    nt = int(cols.max()) + 1
    blocks = spmm.compact_tiles(*_padded(rows, cols, tiles))
    X = np.random.default_rng(r_pad).standard_normal((r_pad, nt * T))
    W, items = _walk_tiles(blocks, X)
    assert_close(W, X @ _symmetric(rows, cols, tiles, nt), rtol=1e-13)
    # one item per block and side: forward, and transposed off the diagonal
    tile = np.repeat(np.arange(len(blocks.tile_row)),
                     np.diff(blocks.tile_ptr))
    off = blocks.tile_row[tile] != blocks.tile_col[tile]
    assert 0 < off.sum() < len(off)
    assert items == len(off) + off.sum()


@pytest.mark.parametrize("source", ["sparse band", "graph"])
def test_tile_walk_with_transposed_diagonal_fails(graph, source):
    rows, cols, tiles = _tile_lists(graph)[source]
    T = tiles.shape[-1]
    nt = int(cols.max()) + 1
    blocks = spmm.compact_tiles(rows, cols, tiles)
    X = np.random.default_rng(5).standard_normal((8, nt * T))
    ref = X @ _symmetric(rows, cols, tiles, nt)
    wrong, _ = _walk_tiles(blocks, X, transpose_diagonal=True)
    assert np.abs(wrong - ref).max() > 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("source", ["sparse band", "graph"])
def test_tile_output_csr_holds_every_block_once_per_side(graph, source):
    """Every entry is one forward item, every entry of an off-diagonal tile
    one transposed item; each item sits in the strip it feeds and reads the
    strip of X its side names; inside a strip the forward items come first,
    then the transposed, each side in entry order (by tile, then a or
    b)."""
    rows, cols, tiles = _tile_lists(graph)[source]
    blocks = spmm.compact_tiles(*_padded(rows, cols, tiles))
    B, T = spmm.BLOCK, blocks.T
    TB = T // B
    out_ptr, out_ent, out_src = blocks[7:]
    assert {a.dtype for a in blocks[7:]} == {np.dtype(np.int32)}
    assert len(out_ptr) == blocks.min_kpad // B + 1
    assert out_ptr[0] == 0 and out_ptr[-1] == len(out_ent) == len(out_src)
    tile = np.repeat(np.arange(len(blocks.tile_row)),
                     np.diff(blocks.tile_ptr))
    r, c = blocks.tile_row[tile], blocks.tile_col[tile]
    a, b = blocks.ent_blk // TB, blocks.ent_blk % TB
    fwd_src, fwd_dst = r * T + a * B, c * T + b * B
    fwd, trn = [], []
    for s in range(len(out_ptr) - 1):
        ents = out_ent[out_ptr[s]:out_ptr[s + 1]]
        side = out_src[out_ptr[s]:out_ptr[s + 1]] & 1
        col = out_src[out_ptr[s]:out_ptr[s + 1]] & ~1
        assert np.all(np.diff(side) >= 0)        # forward first
        f, t = ents[side == 0], ents[side == 1]
        assert np.all(np.diff(f) > 0) and np.all(np.diff(t) > 0)
        assert np.all(fwd_dst[f] == s * B) and np.all(col[side == 0]
                                                      == fwd_src[f])
        assert np.all(fwd_src[t] == s * B) and np.all(col[side == 1]
                                                      == fwd_dst[t])
        assert np.all(r[t] != c[t])
        fwd += list(f)
        trn += list(t)
    assert sorted(fwd) == list(range(len(blocks.ent_blk)))
    assert sorted(trn) == list(np.flatnonzero(r != c))


@pytest.mark.parametrize("source", ["sparse band", "graph"])
@pytest.mark.parametrize("r_pad", [1, 8, 16])
def test_tile_output_csr_walk_matches_plain(graph, r_pad, source):
    """The kernel's summation order over the output CSR, walked in numpy,
    equals spmm_symmetric_plain at f64."""
    rows, cols, tiles = _tile_lists(graph)[source]
    nt, T = int(cols.max()) + 1, tiles.shape[-1]
    blocks = spmm.compact_tiles(*_padded(rows, cols, tiles))
    X = np.random.default_rng(r_pad + 7).standard_normal((r_pad, nt * T))
    W, _ = _walk_tiles(blocks, X)
    plain = spmm.spmm_symmetric_plain(
        spmm.to_device(blocks, torch.float64, "cpu"), torch.as_tensor(X))
    assert_close(W, plain, rtol=1e-13)


# --------------------------------------------------------------------------
# what the wrapper refuses
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wrapper_refuses_an_x_narrower_than_min_kpad(dtype):
    """On the card the kernel would add outside W: refused on every
    device, before anything is applied.  A wider X takes the layout (its
    extra columns get no product)."""
    rows, cols, tiles = _sparse_band()
    nt, T = int(cols.max()) + 1, tiles.shape[-1]
    blocks = spmm.to_device(spmm.compact_tiles(rows, cols, tiles), dtype,
                            "cpu")
    X = torch.ones((8, nt * T), dtype=dtype)
    assert blocks.min_kpad == nt * T
    before = spmm.spmm_symmetric.launches
    for narrow in (X[:, :-T], X[:, :-spmm.BLOCK]):
        with pytest.raises(ValueError, match="reach column"):
            spmm.spmm_symmetric(blocks, narrow.contiguous())
    wide = torch.cat([X, X[:, :T]], 1)
    W = spmm.spmm_symmetric(blocks, wide)
    assert torch.equal(W[:, :nt * T], spmm.spmm_symmetric(blocks, X))
    assert not W[:, nt * T:].any()
    assert spmm.spmm_symmetric.launches == before
