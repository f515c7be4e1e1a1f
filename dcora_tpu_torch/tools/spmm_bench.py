"""Microbenchmark of the SpMM backends of W = X Q on one CUDA device.

    python -m dcora_tpu_torch.tools.spmm_bench [file.g2o|file.pyfg]
        [--rank 5] [--dtype float32|float64] [--out result.json]

Counterpart of ``tools/spmm_bench.py``.  On one graph (default: the
generated 10,648-pose grid; a .pyfg file gives the global range-aided
graph, spheres and landmarks in Q) and one random X, it times

  * the plain tile path (``spmm_sym_plain``: index_select -> bmm ->
    index_add_ over the dense 128 x 128 tiles), whose result is the
    reference of every other row;
  * the library yardstick ``torch.sparse.mm`` on the full symmetric Q in
    CSR form (cuSPARSE), with X^T made outside the timed call; the port
    never calls it;
  * kernel 1, ``spmm_sym`` (owner-computes over output strips of the
    non-empty B x B sub-blocks, B = ``spmm.BLOCK``);
  * kernel 2, ``spmm_symmetric`` (the per-tile list compacted to each
    tile's non-empty sub-blocks, ``spmm.compact_tiles``, owner-computes
    over output strips);
  * kernel 3, ``spmm_paired`` (the row-group packs' non-empty sub-blocks,
    one launch, owner-computes over output strips) on the paired pack and
    on the single-row bucketed pack.

It first reports what Q holds (``common.q_stats``: stored tiles and
non-zeros, kernel 1's strips, sub-blocks and MB).  For each row it prints
ms per product (CUDA events around back-to-back
launches, median of 3 turns), the device ms per product (the kernels' own
durations under torch.profiler, without the host's launch overhead), the
MB of Q data the row's kernel reads (values and the indices it walks), the
error relative to max|W| of the plain result, and the product's bound
(``common.spmm_bound_ms`` at the card's data-sheet HBM rate: Q's stored
non-zeros, X and W).  Refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from dcora_tpu_torch.core import spmm, spmm_pack, tiled
from dcora_tpu_torch.tools import common


def padded_tile_list(Q: tiled.TiledQ, chunk: int = 8):
    """(rows i32, cols i32, tiles) of the stored upper tiles, padded to a
    multiple of `chunk` with zero tiles at (0, 0) as the TPU kernel's list
    is (compact_tiles drops the pads)."""
    pad = -Q.tiles.shape[0] % chunk
    rows = torch.cat([Q.tile_rows, Q.tile_rows.new_zeros(pad)]).int()
    cols = torch.cat([Q.tile_cols, Q.tile_cols.new_zeros(pad)]).int()
    tiles = torch.cat([Q.tiles,
                       Q.tiles.new_zeros((pad,) + tuple(Q.tiles.shape[1:]))])
    return rows, cols, tiles


def tile_blocks(Q: tiled.TiledQ) -> spmm.TileBlocks:
    """Kernel 2's layout: spmm.compact_tiles of padded_tile_list(Q), on
    Q's device at its dtype."""
    lists = (a.cpu().numpy() for a in padded_tile_list(Q))
    return spmm.to_device(spmm.compact_tiles(*lists), Q.tiles.dtype,
                          Q.tiles.device)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def layouts(TP: tiled.TiledProblem, X: torch.Tensor):
    """{row label: (thunk computing W = X Q, bytes of Q data it reads)} of
    every backend, on X."""
    Q, T = TP.Q, TP.meta.T
    dt, dev = Q.tiles.dtype, Q.tiles.device
    trow, tcol = Q.tile_rows.cpu().numpy(), Q.tile_cols.cpu().numpy()
    tiles_np = Q.tiles.cpu().numpy()
    tb = tile_blocks(Q)
    csr, _ = common.symmetric_csr(Q, TP.meta.kpad)
    Xt = X.t().contiguous()
    out = {
        "plain tile path": (
            lambda: spmm.spmm_sym_plain(Q.tiles, Q.tile_rows, Q.tile_cols,
                                        X), _nbytes(Q.tiles)),
        "library torch.sparse.mm (CSR)": (
            lambda: torch.sparse.mm(csr, Xt).t(),
            _nbytes(csr.crow_indices(), csr.col_indices(), csr.values())),
    }
    out[f"spmm_sym (kernel 1, strips B={spmm.BLOCK})"] = (
        lambda: spmm.spmm_sym(Q.strips, X), _nbytes(*Q.strips))
    out[f"spmm_symmetric (kernel 2, tiles B={spmm.BLOCK})"] = (
        lambda: spmm.spmm_symmetric(tb, X), _nbytes(
            tb.vals, tb.out_ptr, tb.out_ent, tb.out_src))
    for name, packer in (("paired", spmm_pack.build_row_pairs_bucketed),
                         ("bucketed R=1",
                          spmm_pack.build_row_groups_bucketed)):
        Pb = spmm.to_device(spmm_pack.compact_buckets(
            packer(trow, tcol, tiles_np, T=T)), dt, dev)
        out[f"{name} (kernel 3, B={spmm.BLOCK})"] = (
            lambda Pb=Pb: spmm.spmm_paired(Pb, X), _nbytes(
                Pb.vals, Pb.out_ptr, Pb.out_ent, Pb.out_src))
    return out


def run(path: str, rank: int = 5, dtype=torch.float32, verbose=True):
    """Time every backend on `path`'s tiles; returns the result dict."""
    common.require_cuda("spmm_bench")
    r_pad = -(-rank // 8) * 8
    g = common.load_graph(path, rank)
    TP = tiled.build_tiled(g.problem_data(device="cuda"), g.dims,
                           dtype=dtype, pack="bucketed")
    name = torch.cuda.get_device_name(0)
    res = dict(device=name, nvidia_smi=common.card(),
               dataset=os.path.basename(path), n=g.dims.n, l=g.dims.l,
               b=g.dims.b, tiles=int(TP.Q.tiles.shape[0]),
               dtype=str(dtype).split(".")[-1], r_pad=r_pad,
               q=common.q_stats(TP), rows=[])
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((r_pad, TP.meta.kpad)),
                        dtype=dtype, device="cuda")
    backends = layouts(TP, X)
    outs = {k: fn() for k, (fn, _) in backends.items()}
    torch.cuda.synchronize()
    ref = outs["plain tile path"]
    scale = float(ref.abs().max())
    ms = common.time_turns_ms([fn for fn, _ in backends.values()])
    gbs = common.nominal_hbm_gbs(name) or common.NOMINAL_HBM_GBS[0][1]
    csr, stored_nnz = common.symmetric_csr(TP.Q, TP.meta.kpad)
    res["bound_ms"], res["bound_by"] = common.spmm_bound_ms(
        stored_nnz, csr.values().numel(), r_pad, TP.meta.kpad, dtype, gbs)
    res["host_build_s"] = host_build_seconds(TP)
    if verbose:
        print(f"{res['dataset']}: n={res['n']} l={res['l']} b={res['b']} "
              f"{res['dtype']} r_pad={r_pad} on {res['nvidia_smi']}; Q: "
              f"{res['q']}")
        print(f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}: "
              f"{stored_nnz} stored non-zeros, X and W once, at the data "
              f"sheet's {gbs:.0f} GB/s); host build s {res['host_build_s']}")
    for (label, (fn, nbytes)), t in zip(backends.items(), ms):
        err = float((outs[label] - ref).abs().max()) / scale
        dev_ms = common.device_ms(fn)
        res["rows"].append(dict(label=label, ms=t, device_ms=dev_ms,
                                q_mb=nbytes / 1e6, rel_err=err))
        if verbose:
            print(f"  {label:40s} {t:8.4f} ms  device {dev_ms:8.4f} ms  "
                  f"{nbytes / 1e6:7.2f} MB of Q  rel err {err:.2e}")
    return res


def host_build_seconds(TP: tiled.TiledProblem) -> dict:
    """Host seconds of the numpy steps that make the sub-block layouts
    from the stored tiles, at spmm.BLOCK: the strip CSR, the per-tile
    compaction (of the padded list), the paired packer and its
    compaction."""
    Q = TP.Q
    trow, tcol = Q.tile_rows.cpu().numpy(), Q.tile_cols.cpu().numpy()
    tiles = Q.tiles.cpu().numpy()
    padded = [a.cpu().numpy() for a in padded_tile_list(Q)]
    tc = time.perf_counter()
    spmm.compact_tiles(*padded)
    t0 = time.perf_counter()
    spmm.build_output_csr(trow, tcol, tiles, TP.meta.nt)
    t1 = time.perf_counter()
    bk = spmm_pack.build_row_pairs_bucketed(trow, tcol, tiles,
                                            T=TP.meta.T)
    t2 = time.perf_counter()
    spmm_pack.compact_buckets(bk)
    t3 = time.perf_counter()
    return dict(strip_csr=t1 - t0, tile_compaction=t0 - tc,
                pair_packer=t2 - t1, compaction=t3 - t2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="",
                    help=".g2o or .pyfg dataset (default: the generated "
                    "10,648-pose grid)")
    ap.add_argument("--rank", type=int, default=5,
                    help="X has ceil(rank / 8) * 8 rows")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    common.require_cuda("spmm_bench")
    with tempfile.TemporaryDirectory() as tmp:
        path = args.path or common.default_grid(tmp)
        res = run(path, rank=args.rank, dtype=getattr(torch, args.dtype))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
