"""The build, binding and launch counts of the port's hand-written CUDA
kernels.

Each kernel library (one ``.cu`` source under ``csrc/``) is built at first
use with ``nvcc`` into ``dcora_tpu_torch/build/`` and loaded with ctypes;
:func:`build_all` builds every library with one ``nvcc`` per source, all
started together.  Nothing is compiled or loaded on import.  The wrappers
live in ``core/spmm.py`` (the SpMM kernels) and ``core/segment.py`` (the
edge path's segment sum); both import this module and neither imports the
other.

Each wrapper counts its launches (:func:`count_launch`,
:func:`launch_counts`).  A launch issued while a CUDA graph is being
captured runs once per replay of that graph, so it is counted per replay
(:func:`captured_counts`, :func:`add_replays`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

import torch

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
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class _Library:
    """One compiled kernel library (one ``.cu`` source), built and loaded
    on first use.  The build's file name carries a hash of the source, the
    headers it includes and the flags; ``build_log`` keeps what ``-Xptxas
    -v`` printed (registers, spills)."""

    def __init__(self, name: str, symbols: Dict[str, list],
                 headers: Sequence[str], defines: Sequence[str]):
        self.name = name
        self.source = os.path.join(CSRC, name + ".cu")
        self.headers = [os.path.join(CSRC, h) for h in headers]
        self.flags = NVCC_FLAGS + list(defines)
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


_BLOCK_DEF = [f"-DDCORA_BLOCK={BLOCK}"]
# name -> (C symbols with their argument types, headers it includes,
# defines)
_SOURCES = {
    "spmm_sym": ({s: [_P] * 5 + [_I, _I, _P]
                  for s in ("dcora_spmm_sym_f32", "dcora_spmm_sym_f64")},
                 ["blocks.cuh"], _BLOCK_DEF),
    "spmm_tile": ({s: [_P] * 7 + [_I] * 3 + [_P]
                   for s in ("dcora_spmm_tile_f32", "dcora_spmm_tile_f64")},
                  ["blocks.cuh"], _BLOCK_DEF),
    "spmm_grouped": ({s: [_P] * 6 + [_I] * 3 + [_P]
                      for s in ("dcora_spmm_grouped_f32",
                                "dcora_spmm_grouped_f64")},
                     ["blocks.cuh"], _BLOCK_DEF),
    "segment_sum": ({s: [_P] * 4 + [_I] * 5 + [_P]
                     for s in ("dcora_segment_sum_f32",
                               "dcora_segment_sum_f64")}, [], []),
}
_LIBRARIES: Dict[str, _Library] = {}
_LIBRARIES_LOCK = threading.Lock()
_ENTRIES: Dict[tuple, object] = {}


def library(name: str) -> _Library:
    """The library of csrc/<name>.cu."""
    with _LIBRARIES_LOCK:
        if name not in _LIBRARIES:
            _LIBRARIES[name] = _Library(name, *_SOURCES[name])
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


def entry(lib: str, dtype: torch.dtype):
    """The C entry point of `lib` for `dtype` (float32 or float64), looked
    up once."""
    fn = _ENTRIES.get((lib, dtype))
    if fn is None:
        suffix = "f32" if dtype == torch.float32 else "f64"
        fn = getattr(library(lib).get(), f"dcora_{lib}_{suffix}")
        _ENTRIES[(lib, dtype)] = fn
    return fn


def stream(X: torch.Tensor) -> int:
    """The raw handle of the current stream on X's device (the stream a
    CUDA graph is capturing, while it captures), without building a
    torch.cuda.Stream object per launch."""
    return torch._C._cuda_getCurrentRawStream(X.get_device())


def check_launch(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# --------------------------------------------------------------------------
# Launch counts, kept on each wrapper (fn.launches, fn.captured)
# --------------------------------------------------------------------------

KERNELS = ("spmm_sym", "spmm_symmetric", "spmm_paired", "segment_sum")
_WRAPPERS: Dict[str, object] = {}


def counted(fn):
    """Register a kernel wrapper (named in KERNELS) for the counts below."""
    assert fn.__name__ in KERNELS, fn.__name__
    fn.launches = fn.captured = 0
    _WRAPPERS[fn.__name__] = fn
    return fn


def count_launch(fn):
    """One launch of fn's kernel: counted now, or, while the current stream
    is capturing a CUDA graph, in fn.captured (counted per replay by the
    graph's owner through add_replays)."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in _WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """Launches per kernel (0 for a wrapper whose module is not loaded)."""
    return {name: getattr(_WRAPPERS.get(name), "launches", 0)
            for name in KERNELS}


def captured_counts() -> Dict[str, int]:
    """Launches recorded into CUDA graphs so far, per kernel."""
    return {name: getattr(_WRAPPERS.get(name), "captured", 0)
            for name in KERNELS}


def add_replays(per_replay: Dict[str, int]):
    """Count one replay of a graph that records per_replay launches of each
    kernel (the difference of captured_counts over its capture)."""
    for name, n in per_replay.items():
        if n:
            _WRAPPERS[name].launches += n
