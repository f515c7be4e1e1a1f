"""Symmetric block-sparse SpMM  W = X Q  (the hand-written CUDA kernels).

Counterpart of ``dcora_tpu.core.pallas_spmm``.  Q is symmetric; only its
upper-triangular T x T tiles are stored, and each stored tile is applied
both ways (the diagonal tile once).  Three kernels, one per TPU kernel:

  * :func:`spmm_sym` -- ``csrc/spmm_sym.cu``, replacing
    ``pallas_spmm.py:_grouped_kernel`` on the default path: owner-computes
    over output tile-columns from a host CSR (:func:`build_output_csr`),
    deterministic, each off-diagonal tile read twice.  It computes every tCG
    Hessian product, cost and gradient of the flat RTR backend and every
    tiled Lanczos matvec unless the paired packing is selected.
  * :func:`spmm_symmetric` -- ``csrc/spmm_tile.cu``, replacing
    ``pallas_spmm.py:_spmm_kernel``: straight from the per-tile list, each
    tile read once, accumulated with atomics.
  * :func:`spmm_grouped` / :func:`spmm_paired` / :func:`spmm_bucketed` --
    ``csrc/spmm_grouped.cu``, one kernel body over wide row-group buffers
    with R rows per group: R = 2 replaces ``pallas_spmm.py:_paired_kernel``,
    R = 1 is the wide-layout ``_grouped_kernel`` (the paired packing's
    leftover buckets, the fixed-G and bucketed layouts).  Atomics as well.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain PyTorch version (index_select -> bmm -> index_add_).  What
bounds each kernel on the H100, and what its design does about it, is
written at the top of its source.

Each library is built at first use with ``nvcc`` from its source in the
package into ``dcora_tpu_torch/build/`` and loaded with ctypes;
:func:`build_all` builds every library with one ``nvcc`` per source, all
started together.  Nothing is compiled or loaded on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

T_TILE = 128

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the SpMM kernels cannot be built")


class _Library:
    """One compiled kernel library (one ``.cu`` source), built and loaded on
    first use.  The build's file name carries a hash of the source, the
    headers it includes and the flags."""

    def __init__(self, name: str, symbols: Dict[str, list],
                 headers: Sequence[str] = ()):
        self.name = name
        self.source = os.path.join(CSRC, name + ".cu")
        self.headers = [os.path.join(CSRC, h) for h in headers]
        self.symbols = symbols
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds = None

    def path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in (self.source, *self.headers):
            with open(f, "rb") as fh:
                h.update(fh.read())
        return os.path.join(BUILD_DIR, f"lib{self.name}_{h.hexdigest()[:12]}"
                                       ".so")

    def start(self):
        """Start nvcc unless a build of this exact source exists; returns
        None or (process, temporary output, start time)."""
        out = self.path()
        if os.path.exists(out):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                 self.source], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        return proc, tmp, time.perf_counter()

    def finish(self, started) -> str:
        out = self.path()
        if started is None:
            return out
        proc, tmp, t0 = started
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"({proc.returncode}):\n{stdout}\n{stderr}")
        os.replace(tmp, out)
        self.build_seconds = time.perf_counter() - t0
        return out

    def build(self) -> str:
        """Compile the library unless a build of this exact source exists."""
        return self.finish(self.start())

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                for sym, argtypes in self.symbols.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


LIBRARIES = {
    "spmm_sym": _Library("spmm_sym", {
        s: [_P] * 6 + [_I, _I, _P]
        for s in ("dcora_spmm_sym_f32", "dcora_spmm_sym_f64")}),
    "spmm_tile": _Library("spmm_tile", {
        s: [_P] * 5 + [_I] * 3 + [_P]
        for s in ("dcora_spmm_tile_f32", "dcora_spmm_tile_f64")},
        headers=["tile_apply.cuh"]),
    "spmm_grouped": _Library("spmm_grouped", {
        s: [_P] * 5 + [_I] * 6 + [_P]
        for s in ("dcora_spmm_grouped_f32", "dcora_spmm_grouped_f64")},
        headers=["tile_apply.cuh"]),
}


def build_all() -> Dict[str, str]:
    """Build every kernel library, one nvcc per source, all started
    together; then load each.  Returns {name: library path}."""
    started = {name: lib.start() for name, lib in LIBRARIES.items()}
    paths = {name: LIBRARIES[name].finish(s) for name, s in started.items()}
    for lib in LIBRARIES.values():
        lib.get()
    return paths


def _entry(lib: str, X: torch.Tensor):
    suffix = "f32" if X.dtype == torch.float32 else "f64"
    return getattr(LIBRARIES[lib].get(), f"dcora_{lib}_{suffix}")


def _stream(X: torch.Tensor) -> int:
    return torch.cuda.current_stream(X.device).cuda_stream


# --------------------------------------------------------------------------
# Operand checks shared by the wrappers
# --------------------------------------------------------------------------


def _check_x(name: str, X: torch.Tensor, tiles: torch.Tensor, T: int):
    if X.dim() != 2:
        raise ValueError(f"{name}: X must be 2-D, got {tuple(X.shape)}")
    if X.dtype not in (torch.float32, torch.float64) or \
            tiles.dtype != X.dtype:
        raise TypeError(f"{name}: X {X.dtype} and tiles {tiles.dtype} "
                        "must share float32 or float64")
    r_pad, kpad = X.shape
    if r_pad < 1 or T < 1 or kpad % T or kpad == 0:
        raise ValueError(f"{name}: bad X shape {tuple(X.shape)} for "
                         f"{T}x{T} tiles")
    if tiles.device != X.device:
        raise ValueError(f"{name}: tiles and X on different devices")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {X.device}")


def _check_kernel(name: str, T: int, X: torch.Tensor, data: torch.Tensor,
                  **index):
    """What a kernel launch needs beyond _check_x: T = 128, contiguous
    operands and contiguous int32 indices on X's device."""
    if T != T_TILE:
        raise ValueError(f"{name}: the kernel takes {T_TILE}x{T_TILE} "
                         f"tiles, got {T}x{T}")
    for iname, a in index.items():
        if a.dtype != torch.int32 or a.device != X.device or \
                not a.is_contiguous():
            raise ValueError(f"{name}: {iname} must be a contiguous int32 "
                             f"tensor on {X.device}")
    if not (X.is_contiguous() and data.is_contiguous()):
        raise ValueError(f"{name}: X and its tiles must be contiguous")


def _launch(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# --------------------------------------------------------------------------
# Kernel 1: owner-computes from the output CSR (csrc/spmm_sym.cu)
# --------------------------------------------------------------------------


def build_output_csr(rows: np.ndarray, cols: np.ndarray,
                     nt: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-output-column entry lists of the upper-triangular tile list.

    Output column o sums X[:, src] A over the stored tiles (src, o) with
    src <= o, and X[:, src] A^T over the stored tiles (o, src) with src > o.
    Returns (out_ptr i32[nt+1], ent_tile i32[ne], ent_src i32[ne]), each
    column's entries in ascending src order (the kernel's summation order).
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if np.any(rows > cols):
        raise ValueError("tile list must be upper-triangular (row <= col)")
    idx = np.arange(len(rows), dtype=np.int64)
    off = rows != cols
    ent_out = np.concatenate([cols, rows[off]])
    ent_tile = np.concatenate([idx, idx[off]])
    ent_src = np.concatenate([rows, cols[off]])
    order = np.lexsort((ent_src, ent_out))
    ent_out, ent_tile, ent_src = ent_out[order], ent_tile[order], \
        ent_src[order]
    out_ptr = np.zeros(nt + 1, np.int64)
    np.cumsum(np.bincount(ent_out, minlength=nt), out=out_ptr[1:])
    return (out_ptr.astype(np.int32), ent_tile.astype(np.int32),
            ent_src.astype(np.int32))


def spmm_sym_plain(tiles: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch W = X Q: index_select -> bmm -> index_add_ over the
    upper-triangular tile list, both directions, diagonal masked."""
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


def spmm_sym(tiles: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
             out_ptr: torch.Tensor, ent_tile: torch.Tensor,
             ent_src: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """W = X Q from the upper-triangular tile list.

    tiles [m, T, T] and X [r_pad, nt*T] share a float dtype (f32 or f64),
    any r_pad >= 1; the kernel takes T = 128, the plain path any T.
    rows/cols index the tiles (plain path); out_ptr/ent_tile/ent_src are
    the int32 CSR of build_output_csr (kernel).
    A CUDA X launches the kernel or raises; a CPU X runs spmm_sym_plain.
    """
    if X.dim() != 2 or tiles.dim() != 3:
        raise ValueError(f"spmm_sym: X must be 2-D and tiles 3-D, got "
                         f"{tuple(X.shape)} and {tuple(tiles.shape)}")
    T = tiles.shape[-1]
    if tiles.shape[1] != T:
        raise ValueError(f"spmm_sym: tiles must be square, got "
                         f"{tuple(tiles.shape)}")
    _check_x("spmm_sym", X, tiles, T)
    if X.device.type == "cpu":
        return spmm_sym_plain(tiles, rows, cols, X)
    _check_kernel("spmm_sym", T, X, tiles, out_ptr=out_ptr,
                  ent_tile=ent_tile, ent_src=ent_src)
    r_pad, kpad = X.shape
    nt = kpad // T
    if out_ptr.dim() != 1 or out_ptr.shape[0] != nt + 1:
        raise ValueError(f"spmm_sym: out_ptr has shape "
                         f"{tuple(out_ptr.shape)}, expected ({nt + 1},)")
    fn = _entry("spmm_sym", X)
    W = torch.empty_like(X)
    with torch.cuda.device(X.device):
        _launch("spmm_sym", fn(
            tiles.data_ptr(), out_ptr.data_ptr(), ent_tile.data_ptr(),
            ent_src.data_ptr(), X.data_ptr(), W.data_ptr(), nt, r_pad,
            _stream(X)))
    spmm_sym.launches += 1
    return W


spmm_sym.launches = 0


# --------------------------------------------------------------------------
# Kernel 2: per-tile list, atomics (csrc/spmm_tile.cu)
# --------------------------------------------------------------------------


def spmm_symmetric_plain(rows: torch.Tensor, cols: torch.Tensor,
                         tiles: torch.Tensor, X: torch.Tensor
                         ) -> torch.Tensor:
    """Plain PyTorch version of spmm_symmetric (the same sum as
    spmm_sym_plain; zero pad tiles add nothing)."""
    return spmm_sym_plain(tiles, rows, cols, X)


def spmm_symmetric(rows: torch.Tensor, cols: torch.Tensor,
                   tiles: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """W = X Q from the per-tile upper-triangular list (rows <= cols),
    each tile read once.  Zero tiles at (0, 0) may pad the list.

    tiles [m, T, T] and X [r_pad, nt*T] share f32 or f64, any r_pad >= 1.
    A CUDA X launches csrc/spmm_tile.cu (rows/cols contiguous int32 [m],
    T = 128) or raises; a CPU X runs spmm_symmetric_plain.
    """
    if tiles.dim() != 3 or tiles.shape[1] != tiles.shape[2]:
        raise ValueError(f"spmm_symmetric: tiles must be [m, T, T], got "
                         f"{tuple(tiles.shape)}")
    T = tiles.shape[-1]
    _check_x("spmm_symmetric", X, tiles, T)
    m = tiles.shape[0]
    if rows.shape != (m,) or cols.shape != (m,):
        raise ValueError(f"spmm_symmetric: rows {tuple(rows.shape)} and "
                         f"cols {tuple(cols.shape)} must be ({m},)")
    if X.device.type == "cpu":
        return spmm_symmetric_plain(rows, cols, tiles, X)
    _check_kernel("spmm_symmetric", T, X, tiles, rows=rows, cols=cols)
    r_pad, kpad = X.shape
    fn = _entry("spmm_tile", X)
    W = torch.empty_like(X)
    with torch.cuda.device(X.device):
        _launch("spmm_symmetric", fn(
            rows.data_ptr(), cols.data_ptr(), tiles.data_ptr(),
            X.data_ptr(), W.data_ptr(), m, kpad // T, r_pad, _stream(X)))
    spmm_symmetric.launches += 1
    return W


spmm_symmetric.launches = 0


# --------------------------------------------------------------------------
# Kernel 3: wide row-group buffers, R rows per group (csrc/spmm_grouped.cu)
# --------------------------------------------------------------------------


def _group_shape(grows, gcols, wide) -> Tuple[int, int, int, int]:
    """(ng, R, G, T) of one bucket, checked for consistency."""
    if gcols.dim() != 2 or wide.dim() != 3:
        raise ValueError(f"grouped SpMM: gcols must be [ng, G] and wide "
                         f"[ng, R*T, G*T], got {tuple(gcols.shape)} and "
                         f"{tuple(wide.shape)}")
    ng, G = gcols.shape
    T = wide.shape[2] // G if G else 0
    R = wide.shape[1] // T if T else 0
    if not (G and T and R in (1, 2) and wide.shape == (ng, R * T, G * T)
            and grows.numel() == ng * R):
        raise ValueError(f"grouped SpMM: inconsistent bucket: grows "
                         f"{tuple(grows.shape)}, gcols {tuple(gcols.shape)}, "
                         f"wide {tuple(wide.shape)}")
    return ng, R, G, T


def spmm_grouped_plain(grows: torch.Tensor, gcols: torch.Tensor,
                       wide: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch W = X Q from one bucket of wide row groups with R = 1
    (grows [ng]) or R = 2 (grows [ng, 2]) rows per group: bmm over the wide
    buffers, then index_add_.  The transposed pass skips slots whose
    column is the group's first row."""
    ng, R, G, T = _group_shape(grows, gcols, wide)
    r_pad, kpad = X.shape
    nt = kpad // T
    grows = grows.reshape(ng, R).long()
    gcols = gcols.long()
    Xt = X.reshape(r_pad, nt, T).transpose(0, 1)           # [nt, r, T]

    def gather(idx, k):  # [ng, k] tile indices -> [ng, r, k*T]
        return Xt.index_select(0, idx.reshape(-1)).reshape(
            ng, k, r_pad, T).transpose(1, 2).reshape(ng, r_pad, k * T)

    def scatter(W, idx, Y, k):  # Y [ng, r, k*T] into W[idx] tiles
        W.index_add_(0, idx.reshape(-1), Y.reshape(
            ng, r_pad, k, T).transpose(1, 2).reshape(ng * k, r_pad, T))

    W = torch.zeros((nt, r_pad, T), dtype=X.dtype, device=X.device)
    scatter(W, gcols, torch.bmm(gather(grows, R), wide), G)
    keep = (gcols != grows[:, :1])[:, None, :, None]       # [ng, 1, G, 1]
    Xc = torch.where(keep, gather(gcols, G).reshape(ng, r_pad, G, T),
                     torch.zeros((), dtype=X.dtype, device=X.device))
    scatter(W, grows, torch.bmm(Xc.reshape(ng, r_pad, G * T),
                                wide.transpose(1, 2)), R)
    return W.transpose(0, 1).reshape(r_pad, kpad)


# the same sum: R comes from the wide buffer's shape
spmm_paired_plain = spmm_grouped_plain


def _grouped_launch(name: str, grows, gcols, wide, X, W, zero: bool):
    """Launch csrc/spmm_grouped.cu for one bucket into W (zeroed first when
    `zero`); counts the launch on spmm_grouped (R = 1) or spmm_paired."""
    ng, R, G, T = _group_shape(grows, gcols, wide)
    _check_x(name, X, wide, T)
    if X.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs a CUDA tensor")
    _check_kernel(name, T, X, wide, grows=grows, gcols=gcols)
    r_pad, kpad = X.shape
    fn = _entry("spmm_grouped", X)
    with torch.cuda.device(X.device):
        _launch(name, fn(grows.data_ptr(), gcols.data_ptr(), wide.data_ptr(),
                         X.data_ptr(), W.data_ptr(), ng, R, G, kpad // T,
                         r_pad, int(zero), _stream(X)))
    if R == 2:
        spmm_paired.launches += 1
    else:
        spmm_grouped.launches += 1


def _one_bucket(name: str, R: int, grows, gcols, wide, X):
    ng, R_have, G, T = _group_shape(grows, gcols, wide)
    if R_have != R or grows.dim() != R:
        raise ValueError(f"{name}: expected a {R}-row bucket, got grows "
                         f"{tuple(grows.shape)} and wide "
                         f"{tuple(wide.shape)}")
    _check_x(name, X, wide, T)
    if X.device.type == "cpu":
        return spmm_grouped_plain(grows, gcols, wide, X)
    W = torch.empty_like(X)
    _grouped_launch(name, grows, gcols, wide, X, W, zero=True)
    return W


def spmm_grouped(grows: torch.Tensor, gcols: torch.Tensor,
                 wide: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """W = X Q from single-row wide groups: grows i32[ng], gcols
    i32[ng, G], wide [ng, T, G*T] (spmm_pack.build_row_groups /
    build_row_groups_bucketed).  A CUDA X launches csrc/spmm_grouped.cu
    with R = 1 or raises; a CPU X runs spmm_grouped_plain."""
    return _one_bucket("spmm_grouped", 1, grows, gcols, wide, X)


def spmm_paired(grows: torch.Tensor, gcols: torch.Tensor,
                wide: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """W = X Q from two-row K-fused groups: grows i32[ng, 2], gcols
    i32[ng, G], wide [ng, 2T, G*T] (spmm_pack.build_row_pairs_bucketed).
    A CUDA X launches csrc/spmm_grouped.cu with R = 2 or raises; a CPU X
    runs spmm_paired_plain."""
    return _one_bucket("spmm_paired", 2, grows, gcols, wide, X)


spmm_grouped.launches = 0
spmm_paired.launches = 0


def spmm_bucketed_plain(buckets, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of spmm_bucketed."""
    W = None
    for grows, gcols, wide in buckets:
        Y = spmm_grouped_plain(grows, gcols, wide, X)
        W = Y if W is None else W + Y
    return W


def spmm_bucketed(buckets, X: torch.Tensor) -> torch.Tensor:
    """W = X Q summed over buckets of wide groups (as built by
    spmm_pack.build_row_groups_bucketed / build_row_pairs_bucketed).  A
    bucket whose wide buffer has 2T contraction rows is a two-row K-fused
    bucket (R = 2), any other a single-row one (R = 1), as
    pallas_spmm.spmm_bucketed dispatches.  On a CUDA X every bucket
    launches csrc/spmm_grouped.cu into one W (the first launch zeroes it);
    on a CPU X the plain versions run."""
    buckets = list(buckets)
    if not buckets:
        raise ValueError("spmm_bucketed: no buckets")
    for grows, gcols, wide in buckets:
        _check_x("spmm_bucketed", X, wide, _group_shape(grows, gcols,
                                                        wide)[3])
    if X.device.type == "cpu":
        return spmm_bucketed_plain(buckets, X)
    W = torch.empty_like(X)
    for i, (grows, gcols, wide) in enumerate(buckets):
        _grouped_launch("spmm_bucketed", grows, gcols, wide, X, W,
                        zero=(i == 0))
    return W


def buckets_to_tensors(buckets, dtype: torch.dtype, device) -> tuple:
    """numpy (grows, gcols, wide) buckets -> contiguous tensors on `device`:
    int32 indices and wide buffers at `dtype`."""
    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return tuple((dev(gr, torch.int32), dev(gc, torch.int32),
                  dev(gw, dtype)) for gr, gc, gw in buckets)


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in (spmm_sym, spmm_symmetric, spmm_grouped, spmm_paired):
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches
            for fn in (spmm_sym, spmm_symmetric, spmm_grouped, spmm_paired)}
