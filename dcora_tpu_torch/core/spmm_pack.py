"""Host-side packers of the upper-triangular tile list into wide groups.

Counterpart of the numpy packers of ``dcora_tpu.core.pallas_spmm``
(``build_row_groups``, ``_row_partition_widths``, ``choose_bucket_widths``,
``build_row_groups_bucketed``, ``build_row_pairs_bucketed``), copied nearly
verbatim:

  * single-row groups ``(grows i[ng], gcols i[ng, G], wide [ng, T, G*T])``:
    the tiles of one tile-row side by side, pad slots at column ``row`` with
    zero tiles;
  * two-row K-fused groups ``(grows i[ng, 2], gcols i[ng, w],
    wide [ng, 2T, w*T])``: two consecutive RCM tile-rows stacked along the
    contraction axis over the union of their columns.

The wide buffers are the TPU kernels' layout.  :func:`compact_buckets`
turns any list of them into what the H100 grouped kernel
(``csrc/spmm_grouped.cu`` through
:func:`dcora_tpu_torch.core.spmm.spmm_paired`) reads: the non-empty B x B
sub-blocks of every slot, grouped by output sub-column, every bucket in one
table.

One deliberate difference: the JAX packers cast the wide buffers to float32;
these keep the dtype of the tiles they are given, so the f64-tile phase and
the tiled Lanczos can use the same layouts.  At float32 the arrays equal the
JAX package's exactly.
"""

from __future__ import annotations

import itertools

import numpy as np

from dcora_tpu_torch.core.spmm import (
    BLOCK,
    PairBlocks,
    item_csr,
    nonempty_blocks,
)

GROUP = 8  # tiles per row-group of the fixed-width layout


def _float_dtype(tiles: np.ndarray):
    return tiles.dtype if tiles.dtype.kind == "f" else np.dtype(np.float32)


def build_row_groups(rows, cols, tiles, T: int = 128, G: int = GROUP):
    """Pack the upper-triangular tile list into fixed-width row-groups.

    Tiles sharing a tile-row are concatenated side by side into wide
    [T, G*T] buffers, each row padded to a G multiple with zero tiles whose
    col == row (both passes of the kernel then add exactly zero).

    Returns (grows i32[ngroups], gcols i32[ngroups, G],
    wide [ngroups, T, G*T]) as numpy arrays, at the tiles' dtype.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    tiles = np.asarray(tiles)
    dt = _float_dtype(tiles)
    order = np.argsort(rows, kind="stable")
    rows, cols, tiles = rows[order], cols[order], tiles[order]

    grows, gcols, gtiles = [], [], []
    i = 0
    m = len(rows)
    while i < m:
        r = rows[i]
        j = i
        while j < m and rows[j] == r:
            j += 1
        for s in range(i, j, G):
            chunk = slice(s, min(s + G, j))
            cs = cols[chunk]
            ts = tiles[chunk]
            pad = G - len(cs)
            if pad:
                cs = np.concatenate([cs, np.full(pad, r, cs.dtype)])
                ts = np.concatenate(
                    [ts, np.zeros((pad, T, T), ts.dtype)])
            grows.append(r)
            gcols.append(cs)
            gtiles.append(np.concatenate(list(ts), axis=1))  # [T, G*T]
        i = j
    if not grows:
        grows = [0]
        gcols = [np.zeros(G, np.int32)]
        gtiles = [np.zeros((T, G * T), dt)]
    return (np.asarray(grows, np.int32),
            np.asarray(gcols, np.int32).reshape(len(grows), G),
            np.stack(gtiles).astype(dt))


def _row_partition_widths(counts, widths, pen: float):
    """DP: cheapest way to cover a row of t tiles with groups whose widths
    come from `widths`, costing (streamed tiles + pen per group).  Returns
    (cost, first) lists over t = 0..max(counts)."""
    tmax = max(counts)
    INF = float("inf")
    cost = [0.0] + [INF] * tmax
    first = [0] * (tmax + 1)
    for t in range(1, tmax + 1):
        for w in widths:
            c = w + pen + cost[max(0, t - w)]
            if c < cost[t]:
                cost[t] = c
                first[t] = w
    return cost, first


def choose_bucket_widths(tile_counts, max_widths: int = 3,
                         pen: float = 0.75):
    """Pick <= max_widths group widths minimizing streamed tiles + a
    per-group penalty (`pen`, in tile units) over the per-row tile-count
    histogram.  Brute force over widths 1..min(max count, 16)."""
    counts = np.asarray(tile_counts)
    hist = {}
    for t in counts:
        hist[int(t)] = hist.get(int(t), 0) + 1
    cand = range(1, min(max(hist) if hist else 1, 16) + 1)
    best, best_w = float("inf"), (8,)
    for k in range(1, max_widths + 1):
        for W in itertools.combinations(cand, k):
            cost, _ = _row_partition_widths(hist, W, pen)
            tot = sum(nrows * cost[t] for t, nrows in hist.items())
            if tot < best:
                best, best_w = tot, W
    return tuple(sorted(best_w))


def build_row_groups_bucketed(rows, cols, tiles, T: int = 128,
                              max_widths: int = 3, pen: float = 0.75):
    """Pack the upper-triangular tile list into row-groups of several widths
    (chosen per dataset by choose_bucket_widths), so streamed bytes stay
    close to the stored tiles.  Returns [(grows, gcols, wide), ...], one
    triple per width, shapes as in build_row_groups; G = gcols.shape[1]."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    tiles = np.asarray(tiles)
    dt = _float_dtype(tiles)
    order = np.argsort(rows, kind="stable")
    rows, cols, tiles = rows[order], cols[order], tiles[order]

    uniq, starts, counts = np.unique(rows, return_index=True,
                                     return_counts=True)
    if not len(uniq):
        return [(np.zeros(1, np.int32), np.zeros((1, 1), np.int32),
                 np.zeros((1, T, T), dt))]
    widths = choose_bucket_widths(counts, max_widths=max_widths, pen=pen)
    _, first = _row_partition_widths(
        {int(t): 1 for t in counts}, widths, pen)

    per_w = {w: ([], [], []) for w in widths}
    for r, s, t in zip(uniq, starts, counts):
        i = int(s)
        left = int(t)
        while left > 0:
            w = first[left]
            take = min(w, left)
            cs = cols[i:i + take]
            ts = tiles[i:i + take]
            if take < w:
                cs = np.concatenate([cs, np.full(w - take, r, cs.dtype)])
                ts = np.concatenate(
                    [ts, np.zeros((w - take, T, T), ts.dtype)])
            g = per_w[w]
            g[0].append(r)
            g[1].append(cs)
            g[2].append(np.concatenate(list(ts), axis=1))
            i += take
            left -= take
    out = []
    for w in widths:
        gr, gc, gt = per_w[w]
        if not gr:
            continue
        out.append((np.asarray(gr, np.int32),
                    np.asarray(gc, np.int32).reshape(len(gr), w),
                    np.stack(gt).astype(dt)))
    return out


def build_row_pairs_bucketed(rows, cols, tiles, T: int = 128,
                             max_widths: int = 3, pen: float = 0.75):
    """Pack the tile list into two-tile-row K-fused groups.

    For a row pair (r1 < r2) of consecutive RCM tile-rows with union column
    set {c_j}, the wide buffer stacks the two rows' subtiles

        A = [[A_{r1,c_1} .. A_{r1,c_w}],      # rows 0..T
             [A_{r2,c_1} .. A_{r2,c_w}]]      # rows T..2T  ([2T, w*T])

    so the forward product is one [r, 2T] @ [2T, w*T] and the transposed
    one a single [r, 2T] result split into the r1 and r2 outputs.

    Constraints baked into the packing:
      * a diagonal tile (r2, r2) cannot ride the fused transposed pass (the
        kernel masks only slots with c == r1, which is safe because
        A_{r2, r1} is strictly lower-triangular, hence absent), so such
        tiles are routed to a single-row leftover bucket;
      * pad slots use column r1 with all-zero subtiles.

    Returns a list of (grows i32[ng, 2], gcols i32[ng, w], wide [ng, 2T, w*T])
    plus single-row buckets for the leftovers (compact_buckets turns them
    into the grouped kernel's PairBlocks).
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    tiles = np.asarray(tiles)
    dt = _float_dtype(tiles)
    by_row: dict = {}
    for r, c, t in zip(rows, cols, tiles):
        by_row.setdefault(int(r), {})[int(c)] = t

    all_rows = sorted(by_row)
    pairs = []
    lo_r, lo_c, lo_t = [], [], []  # leftover single-row tiles

    def spill(r, cmap):
        for c, t in sorted(cmap.items()):
            lo_r.append(r)
            lo_c.append(c)
            lo_t.append(t)

    i = 0
    while i < len(all_rows):
        if i + 1 >= len(all_rows):
            spill(all_rows[i], by_row[all_rows[i]])
            i += 1
            continue
        r1, r2 = all_rows[i], all_rows[i + 1]
        m1 = by_row[r1]
        m2 = dict(by_row[r2])
        if r2 in m2:  # (r2, r2) diagonal: see docstring
            lo_r.append(r2)
            lo_c.append(r2)
            lo_t.append(m2.pop(r2))
        ucols = sorted(set(m1) | set(m2))
        if ucols:
            pairs.append((r1, r2, ucols, m1, m2))
        i += 2

    out = []
    if pairs:
        union_counts = [len(p[2]) for p in pairs]
        widths = choose_bucket_widths(union_counts, max_widths=max_widths,
                                      pen=pen)
        _, first = _row_partition_widths(
            {int(t): 1 for t in union_counts}, widths, pen)
        per_w = {w: ([], [], []) for w in widths}
        for r1, r2, ucols, m1, m2 in pairs:
            left = len(ucols)
            i0 = 0
            while left > 0:
                w = first[left]
                take = min(w, left)
                cs = np.full(w, r1, np.int32)
                sub = np.zeros((2 * T, w * T), dt)
                for j, c in enumerate(ucols[i0:i0 + take]):
                    cs[j] = c
                    if c in m1:
                        sub[:T, j * T:(j + 1) * T] = m1[c]
                    if c in m2:
                        sub[T:, j * T:(j + 1) * T] = m2[c]
                g = per_w[w]
                g[0].append((r1, r2))
                g[1].append(cs)
                g[2].append(sub)
                i0 += take
                left -= take
        for w in widths:
            gr, gc, gt = per_w[w]
            if not gr:
                continue
            out.append((np.asarray(gr, np.int32).reshape(len(gr), 2),
                        np.asarray(gc, np.int32).reshape(len(gr), w),
                        np.stack(gt)))
    if lo_r:
        out.extend(build_row_groups_bucketed(
            np.asarray(lo_r, np.int32), np.asarray(lo_c, np.int32),
            np.stack(lo_t), T=T, max_widths=max_widths, pen=pen))
    if not out:
        out = [(np.zeros(1, np.int32), np.zeros((1, 1), np.int32),
                np.zeros((1, T, T), dt))]
    return out


def compact_buckets(buckets) -> PairBlocks:
    """The non-empty B x B sub-blocks (B = BLOCK) of a list of wide buckets
    (single-row or two-row groups, as the packers above make them), as one
    PairBlocks table of numpy arrays at the buckets' dtype.

    Slot (g, j) of a bucket, with rows r_h = grows[g, h] and column
    c = gcols[g, j], splits its sub-tile A_hj into sub-blocks (a, b); the
    non-empty ones of both rows with the same b form one run (output
    columns cT + bB .. + B, the forward product K-fused over h), ordered by
    (h, a) inside it.  A run is masked (bit 0 of run_col) when c == r_1:
    the r_1 diagonal tile or a pad slot.  Runs are in bucket, slot and b
    order.  min_kpad is one past the last column a run or an entry reaches.

    The output CSR over strips of B columns (out_ptr, out_ent, out_src)
    lists, for strip s, first the entries of the runs whose output strip is
    s (forward, in run and entry order), then the entries of unmasked runs
    whose sub-row strip is s (transposed, in run and entry order, bit 0 of
    out_src set).
    """
    B = BLOCK
    slots, keys, cols, ecols, vals = [], [], [], [], []
    nslot = 0
    for grows, gcols, wide in buckets:
        grows, gcols, wide = (np.asarray(a) for a in (grows, gcols, wide))
        ng, G = gcols.shape
        T = wide.shape[2] // G
        R = wide.shape[1] // T
        if T % B or wide.shape != (ng, R * T, G * T):
            raise ValueError(f"compact_buckets: wide {wide.shape} is not "
                             f"[ng, R*T, G*T] with T a multiple of {B}")
        TB = T // B
        gr = grows.reshape(ng, R).astype(np.int64)
        w7 = wide.reshape(ng, R, TB, B, G, TB, B)
        g, h, a, j, b = np.nonzero(nonempty_blocks(wide).reshape(
            ng, R, TB, G, TB))
        c = gcols[g, j].astype(np.int64)
        slots.append(nslot + g.astype(np.int64) * G + j)
        keys.append(b * (2 * TB) + h * TB + a)   # (b, h, a) inside a slot
        cols.append((c * T + b * B) | (c == gr[g, 0]))
        ecols.append(gr[g, h] * T + a * B)
        vals.append(w7[g, h, a, :, j, b, :])
        nslot += ng * G
    if not slots:
        raise ValueError("compact_buckets: no buckets")
    slot, key = np.concatenate(slots), np.concatenate(keys)
    order = np.lexsort((key, slot))
    slot, key = slot[order], key[order]
    col = np.concatenate(cols)[order]
    # a run starts where the slot or the sub-column changes
    start = np.ones(len(slot), bool)
    start[1:] = (slot[1:] != slot[:-1]) | (col[1:] != col[:-1])
    run_ptr = np.append(np.flatnonzero(start), len(slot))
    ecol = np.concatenate(ecols)[order]
    reach = max(int(np.max(col, initial=0)) & ~1,
                int(np.max(ecol, initial=0))) + B
    ccol = col & ~1
    trn = np.flatnonzero((col & 1) == 0)
    out = item_csr(ccol // B, ecol, trn, ecol[trn] // B, ccol[trn],
                   reach // B)
    i32 = np.int32
    return PairBlocks(run_ptr.astype(i32), col[start].astype(i32),
                      ecol.astype(i32),
                      np.ascontiguousarray(np.concatenate(vals)[order]),
                      reach, *(x.astype(i32) for x in out))
