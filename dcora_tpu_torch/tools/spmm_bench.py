"""Microbenchmark of the SpMM backends of W = X Q on one CUDA device.

    python -m dcora_tpu_torch.tools.spmm_bench [file.g2o] [--rank 5]
        [--dtype float32|float64] [--out result.json]

Counterpart of ``tools/spmm_bench.py``.  On one graph (default: the
generated 10,648-pose grid) and one random X, it times

  * the plain tile path (``spmm_sym_plain``: index_select -> bmm ->
    index_add_), whose result is the reference of every other row;
  * kernel 1, ``spmm_sym`` (owner-computes from the output CSR);
  * kernel 2, ``spmm_symmetric`` (the per-tile list, atomics);
  * kernel 3 with one row per group (R = 1): the fixed-G layout at G = 2, 4,
    8, 16 and the bucketed multi-width layout;
  * kernel 3 on the paired layout (R = 2 plus its R = 1 leftovers).

For each row it prints ms per product (CUDA events around back-to-back
launches, median of 3 turns), the device ms per product (the kernels' own
durations under torch.profiler, without the host's launch overhead: the
bucketed rows launch one kernel per bucket), the tile MB the layout streams,
and the error relative to max|W| of the plain result.  A roofline line,
where printed, uses the card's nominal (data-sheet) HBM bandwidth.  Refuses
to run without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from dcora_tpu_torch.core import spmm, spmm_pack, tiled
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.tools import common


def padded_tile_list(Q: tiled.TiledQ, chunk: int = 8):
    """(rows i32, cols i32, tiles) of the stored upper tiles, padded to a
    multiple of `chunk` with zero tiles at (0, 0) as the TPU kernel's list
    is (spmm_symmetric takes it as it is)."""
    pad = -Q.tiles.shape[0] % chunk
    rows = torch.cat([Q.tile_rows, Q.tile_rows.new_zeros(pad)]).int()
    cols = torch.cat([Q.tile_cols, Q.tile_cols.new_zeros(pad)]).int()
    tiles = torch.cat([Q.tiles,
                       Q.tiles.new_zeros((pad,) + tuple(Q.tiles.shape[1:]))])
    return rows, cols, tiles


def layouts(TP: tiled.TiledProblem):
    """{row label: (fn of X, streamed tile bytes)} of every backend."""
    Q, T = TP.Q, TP.meta.T
    dt, dev = Q.tiles.dtype, Q.tiles.device
    esize = Q.tiles.element_size()
    trow, tcol = Q.tile_rows.cpu().numpy(), Q.tile_cols.cpu().numpy()
    tiles_np = Q.tiles.cpu().numpy()
    tile_b = T * T * esize
    rows, cols, tl = padded_tile_list(Q)
    out = {
        "plain tile path": (
            lambda X: spmm.spmm_sym_plain(Q.tiles, Q.tile_rows,
                                          Q.tile_cols, X),
            Q.tiles.shape[0] * tile_b),
        "spmm_sym (kernel 1, CSR)": (
            lambda X: spmm.spmm_sym(Q.tiles, Q.tile_rows, Q.tile_cols,
                                    Q.out_ptr, Q.ent_tile, Q.ent_src, X),
            Q.ent_tile.shape[0] * tile_b),
        "spmm_symmetric (kernel 2, per tile)": (
            lambda X: spmm.spmm_symmetric(rows, cols, tl, X),
            tl.shape[0] * tile_b),
    }

    def wide_bytes(bk):
        return sum(b[2].numel() for b in bk) * esize

    for G in (2, 4, 8, 16):
        bk = spmm.buckets_to_tensors([spmm_pack.build_row_groups(
            trow, tcol, tiles_np, T=T, G=G)], dt, dev)
        out[f"grouped G={G} (kernel 3, R=1)"] = (
            lambda X, bk=bk: spmm.spmm_grouped(*bk[0], X), wide_bytes(bk))
    for name, packer in (("bucketed", spmm_pack.build_row_groups_bucketed),
                         ("paired", spmm_pack.build_row_pairs_bucketed)):
        bk = spmm.buckets_to_tensors(packer(trow, tcol, tiles_np, T=T),
                                     dt, dev)
        widths = [int(b[1].shape[1]) for b in bk]
        kind = "R=2 + R=1 leftovers" if name == "paired" else "R=1"
        out[f"{name} W={widths} (kernel 3, {kind})"] = (
            lambda X, bk=bk: spmm.spmm_bucketed(bk, X), wide_bytes(bk))
    return out


def run(path: str, rank: int = 5, dtype=torch.float32, verbose=True):
    """Time every backend on `path`'s tiles; returns the result dict."""
    common.require_cuda("spmm_bench")
    r_pad = -(-rank // 8) * 8
    ds = read_g2o_file(path)
    g = LocalGraph(0, rank, ds.dim)
    g.set_measurements(ds.pose_pose_measurements)
    TP = tiled.build_tiled(g.problem_data(device="cuda"), g.dims,
                           dtype=dtype, pack="bucketed")
    name = torch.cuda.get_device_name(0)
    res = dict(device=name, nvidia_smi=common.card(),
               dataset=os.path.basename(path), n=g.dims.n,
               nt=TP.meta.nt, tiles=int(TP.Q.tiles.shape[0]),
               dtype=str(dtype).split(".")[-1], r_pad=r_pad, rows=[])
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((r_pad, TP.meta.kpad)),
                        dtype=dtype, device="cuda")
    backends = layouts(TP)
    outs = {k: fn(X) for k, (fn, _) in backends.items()}
    torch.cuda.synchronize()
    ref = outs["plain tile path"]
    scale = float(ref.abs().max())
    ms = common.time_turns_ms([lambda fn=fn: fn(X)
                               for fn, _ in backends.values()])
    gbs = common.nominal_hbm_gbs(name)
    if verbose:
        print(f"{res['dataset']}: n={res['n']} nt={res['nt']} "
              f"tiles={res['tiles']} {res['dtype']} r_pad={r_pad} on "
              f"{res['nvidia_smi']}")
        if gbs:
            print(f"roofline: nominal HBM bandwidth {gbs:.0f} GB/s "
                  f"(data sheet of {name}, not measured)")
    for (label, (fn, nbytes)), t in zip(backends.items(), ms):
        err = float((outs[label] - ref).abs().max()) / scale
        dev_ms = common.device_ms(lambda: fn(X))
        row = dict(label=label, ms=t, device_ms=dev_ms,
                   streamed_mb=nbytes / 1e6, rel_err=err)
        if gbs:
            row["nominal_bytes_bound_ms"] = nbytes / (gbs * 1e6)
        res["rows"].append(row)
        if verbose:
            bound = ("  (nominal bytes bound "
                     f"{row['nominal_bytes_bound_ms']:.4f} ms)"
                     if gbs else "")
            print(f"  {label:44s} {t:8.4f} ms  device {dev_ms:8.4f} ms  "
                  f"{nbytes / 1e6:7.1f} MB  rel err {err:.2e}{bound}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("g2o", nargs="?", default="",
                    help="dataset (default: the generated 10,648-pose grid)")
    ap.add_argument("--rank", type=int, default=5,
                    help="X has ceil(rank / 8) * 8 rows")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    common.require_cuda("spmm_bench")
    with tempfile.TemporaryDirectory() as tmp:
        path = args.g2o or common.default_grid(tmp)
        res = run(path, rank=args.rank, dtype=getattr(torch, args.dtype))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
