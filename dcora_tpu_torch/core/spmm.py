"""Symmetric sparse SpMM  W = X Q  (the hand-written CUDA kernels).

Counterpart of ``dcora_tpu.core.pallas_spmm``.  Q is symmetric.  The TPU
kernels multiply its upper-triangular 128 x 128 tiles on the matrix unit;
on the pose graphs here ~98.6 % of a stored tile's entries are zero and the
H100 kernels use no matrix unit, so two of the three read only the
non-empty B x B sub-blocks (B = :data:`BLOCK`).  One kernel per TPU kernel:

  * :func:`spmm_sym` -- ``csrc/spmm_sym.cu``, replacing
    ``pallas_spmm.py:_grouped_kernel`` on the default path: owner-computes
    over output strips of B columns from a block CSR of both triangles
    (:func:`build_output_csr`, :class:`StripCSR`), deterministic.  It
    computes every tCG Hessian product, cost and gradient of the flat RTR
    backend and every tiled Lanczos matvec unless the paired packing is
    selected.
  * :func:`spmm_symmetric` -- ``csrc/spmm_tile.cu``, replacing
    ``pallas_spmm.py:_spmm_kernel``: straight from the per-tile list of
    dense tiles, each tile read once, accumulated with atomics.
  * :func:`spmm_paired` -- ``csrc/spmm_grouped.cu``, replacing
    ``pallas_spmm.py:_paired_kernel`` and the wide-layout
    ``_grouped_kernel``: the row-group packs of ``spmm_pack`` (one or two
    RCM tile-rows per group, forward K-fused over the group's rows,
    transposed masked on c == r_1) compacted to their non-empty sub-blocks
    (``spmm_pack.compact_buckets``, :class:`PairBlocks`), every bucket in
    one launch, atomics.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain PyTorch version of the same layout (index_select -> bmm
-> index_add_).  :func:`spmm_sym_plain` over the dense tiles stays as the
reference.  What bounds each kernel on the H100, and what its design does
about it, is written at the top of its source.

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
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

T_TILE = 128
# Edge of the sub-blocks that spmm_sym and spmm_paired read: one constant,
# compiled into their kernels (-DDCORA_BLOCK).  4 is the 3D pose block
# (d + 1) and gives the fewest bytes (B = 8 was slower on the H100: PERF.md).
BLOCK = 4

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the SpMM kernels cannot be built")


class _Library:
    """One compiled kernel library (one ``.cu`` source), built and loaded
    on first use.  The build's file name carries a hash of the source, the
    headers it includes and the flags; ``build_log`` keeps what ``-Xptxas
    -v`` printed (registers, spills)."""

    def __init__(self, name: str, symbols: Dict[str, list],
                 headers: Sequence[str]):
        self.name = name
        self.source = os.path.join(CSRC, name + ".cu")
        self.headers = [os.path.join(CSRC, h) for h in headers]
        self.flags = NVCC_FLAGS + [f"-DDCORA_BLOCK={BLOCK}"]
        self.symbols = symbols
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds = None
        self.build_log = ""

    def path(self) -> str:
        h = hashlib.sha256(" ".join(self.flags).encode())
        for f in (self.source, *self.headers):
            with open(f, "rb") as fh:
                h.update(fh.read())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}_{h.hexdigest()[:12]}.so")

    def start(self):
        """Start nvcc unless a build of this exact source exists; returns
        None or (process, temporary output, start time)."""
        out = self.path()
        if os.path.exists(out):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *self.flags, "-o", tmp,
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
        self.build_log = stdout + stderr
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


# name -> (C symbols with their argument types, headers it includes)
_SOURCES = {
    "spmm_sym": ({s: [_P] * 5 + [_I, _I, _P]
                  for s in ("dcora_spmm_sym_f32", "dcora_spmm_sym_f64")},
                 ["blocks.cuh"]),
    "spmm_tile": ({s: [_P] * 5 + [_I] * 3 + [_P]
                   for s in ("dcora_spmm_tile_f32", "dcora_spmm_tile_f64")},
                  ["tile_apply.cuh"]),
    "spmm_grouped": ({s: [_P] * 6 + [_I] * 3 + [_P]
                      for s in ("dcora_spmm_grouped_f32",
                                "dcora_spmm_grouped_f64")},
                     ["blocks.cuh"]),
}
_LIBRARIES: Dict[str, _Library] = {}
_LIBRARIES_LOCK = threading.Lock()


def library(name: str) -> _Library:
    """The library of csrc/<name>.cu."""
    with _LIBRARIES_LOCK:
        if name not in _LIBRARIES:
            symbols, headers = _SOURCES[name]
            _LIBRARIES[name] = _Library(name, symbols, headers)
        return _LIBRARIES[name]


def build_all() -> Dict[str, _Library]:
    """Build every kernel library, one nvcc per source, all started
    together; then load each.  Returns {name: library}."""
    libs = {name: library(name) for name in _SOURCES}
    started = {name: lib.start() for name, lib in libs.items()}
    for name, s in started.items():
        libs[name].finish(s)
    for lib in libs.values():
        lib.get()
    return libs


def _entry(lib: str, X: torch.Tensor):
    suffix = "f32" if X.dtype == torch.float32 else "f64"
    return getattr(library(lib).get(), f"dcora_{lib}_{suffix}")


def _stream(X: torch.Tensor) -> int:
    return torch.cuda.current_stream(X.device).cuda_stream


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


def _launch(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def to_device(blocks, dtype: torch.dtype, device):
    """A StripCSR / PairBlocks of numpy arrays -> the same NamedTuple of
    contiguous tensors on `device`: int32 indices, values at `dtype`
    (a plain int field stays as it is)."""
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
    nstrip = nt * TB
    ptr = np.zeros(nstrip + 1, np.int64)
    np.cumsum(np.bincount(out, minlength=nstrip), out=ptr[1:])
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
    fn = _entry("spmm_sym", X)
    W = torch.empty_like(X)
    with torch.cuda.device(X.device):
        _launch("spmm_sym", fn(ptr.data_ptr(), src.data_ptr(),
                               vals.data_ptr(), X.data_ptr(), W.data_ptr(),
                               nstrip, r_pad, _stream(X)))
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
    if T != T_TILE:
        raise ValueError(f"spmm_symmetric: the kernel takes "
                         f"{T_TILE}x{T_TILE} tiles, got {T}x{T}")
    _check_kernel("spmm_symmetric", X, tiles, rows=rows, cols=cols)
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
# Kernel 3: the row-group packs' non-empty sub-blocks (csrc/spmm_grouped.cu)
# --------------------------------------------------------------------------


class PairBlocks(NamedTuple):
    """Row-group packs (spmm_pack.build_row_pairs_bucketed and the other
    packers) compacted to their non-empty B x B sub-blocks by
    spmm_pack.compact_buckets.

    A run r is one slot's sub-column: the B output columns starting at
    ``run_col[r] & ~1``; bit 0 of run_col is set when the slot is masked
    (its column is the group's first row) and its transposed products are
    skipped.  The run's entries run_ptr[r]:run_ptr[r+1] are the sub-blocks
    of either row of the group that feed it: entry e sits at the scalar
    column ent_col[e] of its sub-row, with vals[e][kk][jj] =
    A[aB + kk, bB + jj] of its sub-tile A.  min_kpad is one past the last
    scalar column any run or entry reaches: X needs at least that many."""

    run_ptr: torch.Tensor   # i32[nrun + 1]
    run_col: torch.Tensor   # i32[nrun]
    ent_col: torch.Tensor   # i32[ne]
    vals: torch.Tensor      # [ne, B, B]
    min_kpad: int


def spmm_paired_plain(blocks: PairBlocks, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of spmm_paired: per entry, index_select the
    sub-row's and the run's strips of X -> bmm with the block (forward) and
    its transpose (unless masked) -> index_add_ into the run's and the
    sub-row's strips of W."""
    run_ptr, run_col, ent_col, vals, _ = blocks
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


def spmm_paired(blocks: PairBlocks, X: torch.Tensor) -> torch.Tensor:
    """W = X Q from the compacted row-group packs (PairBlocks), every
    bucket in one launch.

    vals [ne, B, B] (B = BLOCK) and X [r_pad, kpad] share f32 or f64, any
    r_pad >= 1, kpad >= blocks.min_kpad.  A CUDA X launches
    csrc/spmm_grouped.cu (contiguous int32 indices) or raises; a CPU X runs
    spmm_paired_plain.
    """
    run_ptr, run_col, ent_col, vals, min_kpad = blocks
    _check_blocks("spmm_paired", vals)
    _check_x("spmm_paired", X, vals, BLOCK)
    nrun = run_col.shape[0]
    if run_ptr.shape != (nrun + 1,) or ent_col.shape != (vals.shape[0],):
        raise ValueError(f"spmm_paired: run_ptr {tuple(run_ptr.shape)} and "
                         f"ent_col {tuple(ent_col.shape)} do not index "
                         f"{nrun} runs and {vals.shape[0]} blocks")
    if X.shape[1] < min_kpad:
        raise ValueError(f"spmm_paired: the packs reach column {min_kpad}, "
                         f"X has {X.shape[1]}")
    if X.device.type == "cpu":
        return spmm_paired_plain(blocks, X)
    _check_kernel("spmm_paired", X, vals, run_ptr=run_ptr, run_col=run_col,
                  ent_col=ent_col)
    r_pad, kpad = X.shape
    fn = _entry("spmm_grouped", X)
    W = torch.empty_like(X)
    with torch.cuda.device(X.device):
        _launch("spmm_paired", fn(
            run_ptr.data_ptr(), run_col.data_ptr(), ent_col.data_ptr(),
            vals.data_ptr(), X.data_ptr(), W.data_ptr(), nrun, kpad, r_pad,
            _stream(X)))
    spmm_paired.launches += 1
    return W


spmm_paired.launches = 0

_COUNTED = (spmm_sym, spmm_symmetric, spmm_paired)


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in _COUNTED}
