"""Symmetric sparse SpMM  W = X Q  (the hand-written CUDA kernels).

Counterpart of ``dcora_tpu.core.pallas_spmm``.  Q is symmetric.  The TPU
kernels multiply its upper-triangular 128 x 128 tiles on the matrix unit;
on the pose graphs here ~98.6 % of a stored tile's entries are zero and the
H100 kernels use no matrix unit, so all three read only the non-empty
B x B sub-blocks (B = :data:`BLOCK`).  One kernel per TPU kernel:

  * :func:`spmm_sym` -- ``csrc/spmm_sym.cu``, replacing
    ``pallas_spmm.py:_grouped_kernel`` on the default path: owner-computes
    over output strips of B columns from a block CSR of both triangles
    (:func:`build_output_csr`, :class:`StripCSR`), deterministic.  It
    computes every tCG Hessian product, cost and gradient of the flat RTR
    backend and every tiled Lanczos matvec unless the paired packing is
    selected.
  * :func:`spmm_symmetric` -- ``csrc/spmm_tile.cu``, replacing
    ``pallas_spmm.py:_spmm_kernel``: the per-tile list compacted to each
    tile's non-empty sub-blocks (:func:`compact_tiles`, :class:`TileBlocks`),
    each block stored once and applied both ways, owner-computes over
    output strips from a CSR of (block, side) items in tile order.
    Deterministic.
  * :func:`spmm_paired` -- ``csrc/spmm_grouped.cu``, replacing
    ``pallas_spmm.py:_paired_kernel`` and the wide-layout
    ``_grouped_kernel``: the row-group packs of ``spmm_pack`` (one or two
    RCM tile-rows per group, forward K-fused over the group's rows,
    transposed masked on c == r_1) compacted to their non-empty sub-blocks
    (``spmm_pack.compact_buckets``, :class:`PairBlocks`), every bucket in
    one launch, owner-computes over output strips from a CSR of (block,
    side) items, each block stored once.  Deterministic.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain PyTorch version of the same layout (index_select -> bmm
-> index_add_).  :func:`spmm_sym_plain` over the dense tiles stays as the
reference.  What bounds each kernel on the H100, and what its design does
about it, is written at the top of its source.

The kernels are built, bound and counted by ``core/kernels.py``, which this
module and ``core/segment.py`` (the edge path's segment sum) share;
``BLOCK``, ``BUILD_DIR``, ``build_all``, ``library``, ``reset_launches`` and
``launch_counts`` are reachable from here as before.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dcora_tpu_torch.core import kernels
from dcora_tpu_torch.core.kernels import (  # noqa: F401  re-exported
    BLOCK,
    BUILD_DIR,
    build_all,
    launch_counts,
    library,
    reset_launches,
)

T_TILE = 128


# --------------------------------------------------------------------------
# Operand checks shared by the wrappers
# --------------------------------------------------------------------------


def _check_x(name: str, X: torch.Tensor, data: torch.Tensor, T: int):
    """X is [r_pad, kpad] with kpad a multiple of T, sharing data's float
    dtype and device, on the CPU or a CUDA device."""
    if X.dim() != 2:
        raise ValueError(f"{name}: X must be 2-D, got {tuple(X.shape)}")
    if X.dtype not in (torch.float32, torch.float64) or \
            data.dtype != X.dtype:
        raise TypeError(f"{name}: X {X.dtype} and Q's values {data.dtype} "
                        "must share float32 or float64")
    r_pad, kpad = X.shape
    if r_pad < 1 or T < 1 or kpad % T or kpad == 0:
        raise ValueError(f"{name}: bad X shape {tuple(X.shape)} for "
                         f"{T}x{T} blocks")
    if data.device != X.device:
        raise ValueError(f"{name}: Q and X on different devices")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {X.device}")


def _check_kernel(name: str, X: torch.Tensor, data: torch.Tensor, **index):
    """What a kernel launch needs beyond _check_x: contiguous operands and
    contiguous int32 indices on X's device."""
    for iname, a in index.items():
        if a.dtype != torch.int32 or a.device != X.device or \
                not a.is_contiguous():
            raise ValueError(f"{name}: {iname} must be a contiguous int32 "
                             f"tensor on {X.device}")
    if not (X.is_contiguous() and data.is_contiguous()):
        raise ValueError(f"{name}: X and Q's values must be contiguous")


def _check_blocks(name: str, vals: torch.Tensor):
    """vals holds [ne, B, B] sub-blocks, B = BLOCK."""
    if vals.dim() != 3 or vals.shape[1:] != (BLOCK, BLOCK):
        raise ValueError(f"{name}: vals must be [ne, B, B] sub-blocks with "
                         f"B = {BLOCK}, got {tuple(vals.shape)}")


def to_device(blocks, dtype: torch.dtype, device):
    """A StripCSR / TileBlocks / PairBlocks of numpy arrays -> the same
    NamedTuple of contiguous tensors on `device`: int32 indices, values at
    `dtype` (a plain int field stays as it is)."""
    def dev(a):
        if isinstance(a, int):
            return a
        a = np.ascontiguousarray(a)
        dt = dtype if a.dtype.kind == "f" else torch.int32
        return torch.as_tensor(a, dtype=dt, device=device)

    return type(blocks)(*(dev(a) for a in blocks))


def nonempty_blocks(a: np.ndarray) -> np.ndarray:
    """Mask [n, H/B, W/B] of the B x B blocks (B = BLOCK) of a [n, H, W]
    that hold a non-zero.  It reads each B-wide bool row as one B-byte
    integer, so the pass costs about one comparison over `a`."""
    n, H, W = a.shape
    B = BLOCK
    nz = np.ascontiguousarray(a != 0)
    return (nz.view(f"u{B}").reshape(n, H // B, B, W // B) != 0).any(axis=2)


def _strips_of(X: torch.Tensor) -> torch.Tensor:
    """[r_pad, kpad] -> [kpad / B, r_pad, B] (strip-major view)."""
    r_pad, kpad = X.shape
    return X.reshape(r_pad, kpad // BLOCK, BLOCK).transpose(0, 1)


def _from_strips(Ws: torch.Tensor) -> torch.Tensor:
    nstrip, r_pad, B = Ws.shape
    return Ws.transpose(0, 1).reshape(r_pad, nstrip * B)


def csr_offsets(keys: np.ndarray, n: int) -> np.ndarray:
    """The CSR offsets [n + 1] (int64) of the non-negative int keys (< n):
    row s's entries, once sorted by key, are offsets[s]:offsets[s + 1]."""
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n), out=ptr[1:])
    return ptr


# --------------------------------------------------------------------------
# Kernel 1: owner-computes over output strips (csrc/spmm_sym.cu)
# --------------------------------------------------------------------------


class StripCSR(NamedTuple):
    """Q as a block CSR over output strips of B scalar columns, both
    triangles: strip s's entries ptr[s]:ptr[s+1] are the non-empty blocks
    of Q that feed it, vals[e][q][k] = Q[src[e]B + k, sB + q] (the block
    transposed, so that a row of vals is one output column), in ascending
    src order (the kernel's summation order)."""

    ptr: torch.Tensor    # i32[kpad / B + 1]
    src: torch.Tensor    # i32[ne]
    vals: torch.Tensor   # [ne, B, B]


def build_output_csr(rows, cols, tiles, nt: int) -> StripCSR:
    """The StripCSR (numpy arrays, values at the tiles' dtype) of the
    upper-triangular tile list (rows <= cols) of nt tile-columns.

    A stored tile A at (r, c) holds Q's blocks (r, c); each of its non-empty
    B x B sub-blocks A_ab feeds output strip cT/B + b from source strip
    rT/B + a as A_ab^T and, off the diagonal, output strip rT/B + a from
    source strip cT/B + b as A_ab.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    tiles = np.asarray(tiles)
    if np.any(rows > cols):
        raise ValueError("tile list must be upper-triangular (row <= col)")
    m, T = tiles.shape[0], tiles.shape[-1]
    B = BLOCK
    if T % B:
        raise ValueError(f"{T}x{T} tiles do not split into {B}x{B} blocks")
    TB = T // B
    t5 = tiles.reshape(m, TB, B, TB, B)
    t, a, b = np.nonzero(nonempty_blocks(tiles))
    blk = t5[t, a, :, b, :]                               # [n, B, B]
    src_f = rows[t] * TB + a
    out_f = cols[t] * TB + b
    off = rows[t] != cols[t]
    out = np.concatenate([out_f, src_f[off]])
    src = np.concatenate([src_f, out_f[off]])
    vals = np.concatenate([blk.transpose(0, 2, 1), blk[off]])
    order = np.lexsort((src, out))
    ptr = csr_offsets(out, nt * TB)
    return StripCSR(ptr.astype(np.int32), src[order].astype(np.int32),
                    np.ascontiguousarray(vals[order]))


def spmm_sym_plain(tiles: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch W = X Q over the dense upper-triangular tile list:
    index_select -> bmm -> index_add_, both directions, diagonal masked.
    The reference of every layout."""
    r_pad, kpad = X.shape
    T = tiles.shape[-1]
    nt = kpad // T
    rows, cols = rows.long(), cols.long()
    Xt = X.reshape(r_pad, nt, T).transpose(0, 1)           # [nt, r, T]
    W = torch.zeros((nt, r_pad, T), dtype=X.dtype, device=X.device)
    W.index_add_(0, cols, torch.bmm(Xt.index_select(0, rows), tiles))
    off = (rows != cols).to(X.dtype)[:, None, None]
    W.index_add_(0, rows, off * torch.bmm(Xt.index_select(0, cols),
                                          tiles.transpose(1, 2)))
    return W.transpose(0, 1).reshape(r_pad, kpad)


def spmm_strips_plain(strips: StripCSR, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of spmm_sym on the StripCSR: index_select the
    source strips -> bmm with the blocks -> index_add_ into the output
    strips."""
    ptr, src, vals = strips
    Xs = _strips_of(X)
    out = torch.repeat_interleave(
        torch.arange(ptr.shape[0] - 1, device=X.device),
        (ptr[1:] - ptr[:-1]).long())
    Ws = torch.zeros_like(Xs)
    Ws.index_add_(0, out, torch.bmm(Xs.index_select(0, src.long()),
                                    vals.transpose(1, 2)))
    return _from_strips(Ws)


@kernels.counted
def spmm_sym(strips: StripCSR, X: torch.Tensor) -> torch.Tensor:
    """W = X Q from the StripCSR of Q (build_output_csr).

    vals [ne, B, B] (B = BLOCK) and X [r_pad, kpad] share f32 or f64, any
    r_pad >= 1; ptr has kpad / B + 1 entries.  A CUDA X launches
    csrc/spmm_sym.cu (contiguous int32 ptr/src) or raises; a CPU X runs
    spmm_strips_plain.
    """
    ptr, src, vals = strips
    _check_blocks("spmm_sym", vals)
    _check_x("spmm_sym", X, vals, BLOCK)
    r_pad, kpad = X.shape
    nstrip = kpad // BLOCK
    if ptr.dim() != 1 or ptr.shape[0] != nstrip + 1 or \
            src.shape != (vals.shape[0],):
        raise ValueError(f"spmm_sym: ptr {tuple(ptr.shape)} and src "
                         f"{tuple(src.shape)} do not index {nstrip} strips "
                         f"and {vals.shape[0]} blocks")
    if X.device.type == "cpu":
        return spmm_strips_plain(strips, X)
    _check_kernel("spmm_sym", X, vals, ptr=ptr, src=src)
    fn = kernels.entry("spmm_sym", X.dtype)
    W = torch.empty_like(X)
    with torch.cuda.device(X.device):
        kernels.check_launch("spmm_sym", fn(
            ptr.data_ptr(), src.data_ptr(), vals.data_ptr(), X.data_ptr(),
            W.data_ptr(), nstrip, r_pad, kernels.stream(X)))
    kernels.count_launch(spmm_sym)
    return W



# --------------------------------------------------------------------------
# Kernel 2: the per-tile list's non-empty sub-blocks (csrc/spmm_tile.cu)
# --------------------------------------------------------------------------


class TileBlocks(NamedTuple):
    """The upper-triangular per-tile list (rows <= cols) cut down to each
    tile's non-empty B x B sub-blocks, in tile order, with the output CSR
    the kernel walks.

    Tile t sits at tile row tile_row[t] and tile column tile_col[t] (it is
    a diagonal tile when the two are equal: its transposed products are
    skipped); its entries are tile_ptr[t]:tile_ptr[t+1].  Entry e is the
    sub-block (a, b) of its T x T tile A, stored as ent_blk[e] = a * (T/B)
    + b, with vals[e][kk][jj] = A[aB + kk, bB + jj]; a tile's entries are
    sorted by b, then a.  min_kpad is one past the last scalar column any
    entry reaches: X needs at least that many.

    The output CSR, as PairBlocks': output strip s (B columns from sB)
    sums the items out_ptr[s]:out_ptr[s+1].  Item i applies block
    out_ent[i] to the strip of X at scalar column out_src[i] & ~1: forward
    (bit 0 clear: the entries whose sub-column cT + bB is strip s, in entry
    order, so by tile, then a; X at rT + aB) before transposed (bit 0 set:
    the entries of off-diagonal tiles whose sub-row rT + aB is strip s, by
    tile, then b; X at cT + bB).  Strips at or past len(out_ptr) - 1 get
    no item."""

    tile_ptr: torch.Tensor   # i32[ntile + 1]
    tile_row: torch.Tensor   # i32[ntile]
    tile_col: torch.Tensor   # i32[ntile]
    ent_blk: torch.Tensor    # i32[ne]
    vals: torch.Tensor       # [ne, B, B]
    T: int
    min_kpad: int
    out_ptr: torch.Tensor    # i32[min_kpad / B + 1]
    out_ent: torch.Tensor    # i32[nitem]
    out_src: torch.Tensor    # i32[nitem]


def item_csr(fwd_strip, fwd_src, trn_ent, trn_strip, trn_src, nstrip):
    """The output CSR (out_ptr, out_ent, out_src; int64) of kernels 2 and
    3: every entry e as a forward item into strip fwd_strip[e] from the
    scalar column fwd_src[e] of X, and the entries trn_ent as transposed
    items into trn_strip from trn_src (bit 0 set); strip by strip, forward
    before transposed, each side in entry order."""
    ne = len(fwd_strip)
    strip = np.concatenate([fwd_strip, trn_strip])
    side = np.concatenate([np.zeros(ne, np.int64),
                           np.ones(len(trn_ent), np.int64)])
    ent = np.concatenate([np.arange(ne), trn_ent])
    src = np.concatenate([fwd_src, np.asarray(trn_src) | 1])
    items = np.lexsort((ent, side, strip))
    return csr_offsets(strip, nstrip), ent[items], src[items]


def compact_tiles(rows, cols, tiles) -> TileBlocks:
    """The TileBlocks (numpy arrays, values at the tiles' dtype) of an
    upper-triangular tile list.  Tiles and sub-blocks that hold no non-zero
    are dropped, so are the zero tiles that pad the TPU kernel's list to
    whole chunks.  A diagonal tile's blocks are kept as stored, not
    symmetrised: the reference applies such a tile as X A only."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    tiles = np.asarray(tiles)
    if np.any(rows > cols):
        raise ValueError("tile list must be upper-triangular (row <= col)")
    m, T = tiles.shape[0], tiles.shape[-1]
    B = BLOCK
    if tiles.shape != (m, T, T) or T % B:
        raise ValueError(f"{tuple(tiles.shape)} tiles do not split into "
                         f"{B}x{B} blocks")
    TB = T // B
    t, a, b = np.nonzero(nonempty_blocks(tiles))
    order = np.lexsort((a, b, t))
    t, a, b = t[order], a[order], b[order]
    keep, tix, count = np.unique(t, return_inverse=True, return_counts=True)
    tile_ptr = np.zeros(len(keep) + 1, np.int64)
    np.cumsum(count, out=tile_ptr[1:])
    r, c = rows[keep][tix], cols[keep][tix]
    src, dst = r * T + a * B, c * T + b * B   # scalar columns of X and W
    min_kpad = int(np.maximum(src, dst).max()) + B if len(t) else 0
    off = np.flatnonzero(r != c)
    out = item_csr(dst // B, src, off, src[off] // B, dst[off],
                   min_kpad // B)
    i32 = np.int32
    return TileBlocks(
        tile_ptr.astype(i32), rows[keep].astype(i32), cols[keep].astype(i32),
        (a * TB + b).astype(i32),
        np.ascontiguousarray(tiles.reshape(m, TB, B, TB, B)[t, a, :, b, :]),
        T, min_kpad, *(x.astype(i32) for x in out))


def spmm_symmetric_plain(blocks: TileBlocks, X: torch.Tensor
                         ) -> torch.Tensor:
    """Plain PyTorch version of spmm_symmetric: per entry, index_select the
    tile row's and the tile column's strips of X -> bmm with the block
    (forward) and, off the diagonal, its transpose -> index_add_ into the
    tile column's and the tile row's strips of W."""
    tile_ptr, tile_row, tile_col, ent_blk, vals, T = blocks[:6]
    TB = T // BLOCK
    tile = torch.repeat_interleave(
        torch.arange(tile_row.shape[0], device=X.device),
        (tile_ptr[1:] - tile_ptr[:-1]).long())
    r, c = tile_row.long()[tile], tile_col.long()[tile]
    blk = ent_blk.long()
    src = r * TB + blk // TB          # strip of X[:, rT + aB]
    dst = c * TB + blk % TB           # strip of X[:, cT + bB]
    Xs = _strips_of(X)
    Ws = torch.zeros_like(Xs)
    Ws.index_add_(0, dst, torch.bmm(Xs.index_select(0, src), vals))
    off = r != c
    Ws.index_add_(0, src[off], torch.bmm(Xs.index_select(0, dst[off]),
                                         vals[off].transpose(1, 2)))
    return _from_strips(Ws)


@kernels.counted
def spmm_symmetric(blocks: TileBlocks, X: torch.Tensor) -> torch.Tensor:
    """W = X Q from the per-tile list's non-empty sub-blocks (TileBlocks,
    compact_tiles), each block stored once.

    vals [ne, B, B] (B = BLOCK) and X [r_pad, kpad] share f32 or f64, any
    r_pad >= 1, kpad >= blocks.min_kpad.  A CUDA X launches
    csrc/spmm_tile.cu (contiguous int32 indices, T = 128; it walks the
    output CSR, writing every strip of W once) or raises; a CPU X runs
    spmm_symmetric_plain.
    """
    (tile_ptr, tile_row, tile_col, ent_blk, vals, T, min_kpad, out_ptr,
     out_ent, out_src) = blocks
    _check_blocks("spmm_symmetric", vals)
    _check_x("spmm_symmetric", X, vals, BLOCK)
    ntile = tile_row.shape[0]
    if tile_ptr.shape != (ntile + 1,) or tile_col.shape != (ntile,) or \
            ent_blk.shape != (vals.shape[0],) or \
            out_ptr.shape != (min_kpad // BLOCK + 1,) or \
            out_src.shape != out_ent.shape:
        raise ValueError(f"spmm_symmetric: tile_ptr {tuple(tile_ptr.shape)}, "
                         f"tile_col {tuple(tile_col.shape)}, ent_blk "
                         f"{tuple(ent_blk.shape)}, out_ptr "
                         f"{tuple(out_ptr.shape)} and out_src "
                         f"{tuple(out_src.shape)} do not index {ntile} "
                         f"tiles, {vals.shape[0]} blocks, "
                         f"{min_kpad // BLOCK} strips and "
                         f"{out_ent.shape[0]} items")
    if X.shape[1] < min_kpad:
        raise ValueError(f"spmm_symmetric: the tiles reach column "
                         f"{min_kpad}, X has {X.shape[1]}")
    if X.device.type == "cpu":
        return spmm_symmetric_plain(blocks, X)
    if T != T_TILE:
        raise ValueError(f"spmm_symmetric: the kernel takes "
                         f"{T_TILE}x{T_TILE} tiles, got {T}x{T}")
    _check_kernel("spmm_symmetric", X, vals, tile_ptr=tile_ptr,
                  tile_row=tile_row, tile_col=tile_col, ent_blk=ent_blk,
                  out_ptr=out_ptr, out_ent=out_ent, out_src=out_src)
    r_pad, kpad = X.shape
    fn = kernels.entry("spmm_tile", X.dtype)
    W = torch.empty_like(X)
    with torch.cuda.device(X.device):
        kernels.check_launch("spmm_symmetric", fn(
            out_ptr.data_ptr(), out_ent.data_ptr(), out_src.data_ptr(),
            vals.data_ptr(), X.data_ptr(), W.data_ptr(),
            out_ptr.shape[0] - 1, kpad, r_pad, kernels.stream(X)))
    kernels.count_launch(spmm_symmetric)
    return W


# --------------------------------------------------------------------------
# Kernel 3: the row-group packs' non-empty sub-blocks (csrc/spmm_grouped.cu)
# --------------------------------------------------------------------------


class PairBlocks(NamedTuple):
    """Row-group packs (spmm_pack.build_row_pairs_bucketed and the other
    packers) compacted to their non-empty B x B sub-blocks by
    spmm_pack.compact_buckets, with the output CSR the kernel walks.

    A run r is one slot's sub-column: the B output columns starting at
    ``run_col[r] & ~1``; bit 0 of run_col is set when the slot is masked
    (its column is the group's first row) and its transposed products are
    skipped.  The run's entries run_ptr[r]:run_ptr[r+1] are the sub-blocks
    of either row of the group that feed it: entry e sits at the scalar
    column ent_col[e] of its sub-row, with vals[e][kk][jj] =
    A[aB + kk, bB + jj] of its sub-tile A.  min_kpad is one past the last
    scalar column any run or entry reaches: X needs at least that many.

    The output CSR: output strip s (B columns from sB) sums the items
    out_ptr[s]:out_ptr[s+1].  Item i applies block out_ent[i] to the strip
    of X at scalar column out_src[i] & ~1: forward (bit 0 clear: the entries
    of the runs whose output strip is s, run by run, each run's entries in
    its (h, a) order, X at the entry's sub-row) before transposed (bit 0
    set: the entries of unmasked runs whose sub-row strip is s, in (run,
    entry) order, X at the run's columns).  Each block is stored once and
    may be named by a forward and a transposed item.  Strips at or past
    len(out_ptr) - 1 get no item."""

    run_ptr: torch.Tensor   # i32[nrun + 1]
    run_col: torch.Tensor   # i32[nrun]
    ent_col: torch.Tensor   # i32[ne]
    vals: torch.Tensor      # [ne, B, B]
    min_kpad: int
    out_ptr: torch.Tensor   # i32[min_kpad / B + 1]
    out_ent: torch.Tensor   # i32[nitem]
    out_src: torch.Tensor   # i32[nitem]


def spmm_paired_plain(blocks: PairBlocks, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of spmm_paired: per entry, index_select the
    sub-row's and the run's strips of X -> bmm with the block (forward) and
    its transpose (unless masked) -> index_add_ into the run's and the
    sub-row's strips of W."""
    run_ptr, run_col, ent_col, vals = blocks[:4]
    B = BLOCK
    Xs = _strips_of(X)
    run = torch.repeat_interleave(
        torch.arange(run_col.shape[0], device=X.device),
        (run_ptr[1:] - run_ptr[:-1]).long())
    rc = run_col.long()[run]
    cs = (rc >> 1 << 1) // B          # the run's output strip
    es = ent_col.long() // B          # the entry's sub-row strip
    Ws = torch.zeros_like(Xs)
    Ws.index_add_(0, cs, torch.bmm(Xs.index_select(0, es), vals))
    keep = (rc & 1) == 0
    Ws.index_add_(0, es[keep], torch.bmm(Xs.index_select(0, cs[keep]),
                                         vals[keep].transpose(1, 2)))
    return _from_strips(Ws)


@kernels.counted
def spmm_paired(blocks: PairBlocks, X: torch.Tensor) -> torch.Tensor:
    """W = X Q from the compacted row-group packs (PairBlocks), every
    bucket in one launch.

    vals [ne, B, B] (B = BLOCK) and X [r_pad, kpad] share f32 or f64, any
    r_pad >= 1, kpad >= blocks.min_kpad.  A CUDA X launches
    csrc/spmm_grouped.cu (contiguous int32 indices; it walks the output
    CSR, writing every strip of W once) or raises; a CPU X runs
    spmm_paired_plain.
    """
    (run_ptr, run_col, ent_col, vals, min_kpad, out_ptr, out_ent,
     out_src) = blocks
    _check_blocks("spmm_paired", vals)
    _check_x("spmm_paired", X, vals, BLOCK)
    nrun = run_col.shape[0]
    if run_ptr.shape != (nrun + 1,) or ent_col.shape != (vals.shape[0],) \
            or out_ptr.shape != (min_kpad // BLOCK + 1,) or \
            out_src.shape != out_ent.shape:
        raise ValueError(f"spmm_paired: run_ptr {tuple(run_ptr.shape)}, "
                         f"ent_col {tuple(ent_col.shape)}, out_ptr "
                         f"{tuple(out_ptr.shape)} and out_src "
                         f"{tuple(out_src.shape)} do not index {nrun} runs, "
                         f"{vals.shape[0]} blocks, {min_kpad // BLOCK} "
                         f"strips and {out_ent.shape[0]} items")
    if X.shape[1] < min_kpad:
        raise ValueError(f"spmm_paired: the packs reach column {min_kpad}, "
                         f"X has {X.shape[1]}")
    if X.device.type == "cpu":
        return spmm_paired_plain(blocks, X)
    _check_kernel("spmm_paired", X, vals, run_ptr=run_ptr, run_col=run_col,
                  ent_col=ent_col, out_ptr=out_ptr, out_ent=out_ent,
                  out_src=out_src)
    r_pad, kpad = X.shape
    fn = kernels.entry("spmm_grouped", X.dtype)
    W = torch.empty_like(X)
    with torch.cuda.device(X.device):
        kernels.check_launch("spmm_paired", fn(
            out_ptr.data_ptr(), out_ent.data_ptr(), out_src.data_ptr(),
            vals.data_ptr(), X.data_ptr(), W.data_ptr(),
            out_ptr.shape[0] - 1, kpad, r_pad, kernels.stream(X)))
    kernels.count_launch(spmm_paired)
    return W
