"""Symmetric block-sparse SpMM  W = X Q  (the hand-written CUDA kernel).

Counterpart of ``dcora_tpu.core.pallas_spmm``: this module replaces the TPU
kernel ``dcora_tpu/core/pallas_spmm.py:_grouped_kernel`` (run per width
bucket by ``spmm_bucketed``).  It computes every tCG Hessian product, every
cost and gradient of the flat RTR backend and every tiled Lanczos matvec.

Q is symmetric; only its upper-triangular T x T tiles are stored, and each
stored tile is applied both ways (the diagonal tile once).  On a CUDA tensor
:func:`spmm_sym` launches ``csrc/spmm_sym.cu`` or raises; on a CPU tensor it
runs :func:`spmm_sym_plain`, the plain PyTorch version of the same sum.

What bounds it on the H100, and what the design does about it, is written
at the top of ``csrc/spmm_sym.cu``: tile bytes bound it (about 4 flop per
byte in f32 at r_pad 8), and the kernel is owner-computes over output
tile-columns, reading a host-built CSR index (``out_ptr``, ``ent_tile``,
``ent_src``; see :func:`build_output_csr`) that replaces the TPU kernel's
width buckets.

The library is built at first use with ``nvcc`` from the sources in the
package into ``dcora_tpu_torch/build/`` and loaded with ctypes; nothing is
compiled or loaded on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Tuple

import numpy as np
import torch

T_TILE = 128

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "spmm_sym.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


class _Library:
    """The compiled kernel library, built and loaded on first use."""

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds = None

    def _nvcc(self) -> str:
        for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
            if cand and os.path.exists(cand):
                return cand
        raise RuntimeError("nvcc not found: the SpMM kernel cannot be built")

    def path(self) -> str:
        with open(SOURCE, "rb") as fh:
            tag = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()
                                 ).hexdigest()[:12]
        return os.path.join(BUILD_DIR, f"libspmm_sym_{tag}.so")

    def build(self) -> str:
        """Compile the library unless a build of this exact source exists."""
        import time

        out = self.path()
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([self._nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        self.build_seconds = time.perf_counter() - t0
        return out

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                for name in ("dcora_spmm_sym_f32", "dcora_spmm_sym_f64"):
                    fn = getattr(lib, name)
                    fn.argtypes = [ctypes.c_void_p] * 6 + [
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


LIBRARY = _Library()


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
    if X.dtype not in (torch.float32, torch.float64) or \
            tiles.dtype != X.dtype:
        raise TypeError(f"spmm_sym: X {X.dtype} and tiles {tiles.dtype} "
                        "must share float32 or float64")
    T = tiles.shape[-1]
    if tiles.shape[1] != T:
        raise ValueError(f"spmm_sym: tiles must be square, got "
                         f"{tuple(tiles.shape)}")
    r_pad, kpad = X.shape
    if r_pad < 1 or kpad % T or kpad == 0:
        raise ValueError(f"spmm_sym: bad X shape {tuple(X.shape)} for "
                         f"{T}x{T} tiles")
    nt = kpad // T
    if tiles.device != X.device:
        raise ValueError("spmm_sym: tiles and X on different devices")
    if X.device.type == "cpu":
        return spmm_sym_plain(tiles, rows, cols, X)
    if X.device.type != "cuda":
        raise ValueError(f"spmm_sym: unsupported device {X.device}")
    if T != T_TILE:
        raise ValueError(f"spmm_sym: the kernel takes {T_TILE}x{T_TILE} "
                         f"tiles, got {T}x{T}")
    for name, a in (("out_ptr", out_ptr), ("ent_tile", ent_tile),
                    ("ent_src", ent_src)):
        if a.dtype != torch.int32 or a.device != X.device or \
                not a.is_contiguous() or a.dim() != 1:
            raise ValueError(f"spmm_sym: {name} must be a contiguous int32 "
                             f"vector on {X.device}")
    if out_ptr.shape[0] != nt + 1:
        raise ValueError(f"spmm_sym: out_ptr has {out_ptr.shape[0]} entries,"
                         f" expected nt + 1 = {nt + 1}")
    if not (X.is_contiguous() and tiles.is_contiguous()):
        raise ValueError("spmm_sym: X and tiles must be contiguous")
    lib = LIBRARY.get()
    fn = (lib.dcora_spmm_sym_f32 if X.dtype == torch.float32
          else lib.dcora_spmm_sym_f64)
    W = torch.empty_like(X)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(tiles.data_ptr(), out_ptr.data_ptr(), ent_tile.data_ptr(),
                 ent_src.data_ptr(), X.data_ptr(), W.data_ptr(), nt, r_pad,
                 stream)
    if err != 0:
        raise RuntimeError(f"spmm_sym kernel launch failed: CUDA error {err}")
    spmm_sym.launches += 1
    return W


spmm_sym.launches = 0
