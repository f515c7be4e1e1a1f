"""The yardstick of the kernels' roofline shares: the card's published
peaks and the least work each kernel's launch has to do, counted from the
problem (its edges, the rank r and the state's k columns), never from the
port's own layout (tiles, r_pad, kpad), so the count stays the same
whatever implements it.

A launch's least time is the larger of its bytes over the HBM rate and its
operations over the peak outside the tensor cores (none of these kernels
has a matrix instruction to use).  Every input byte is counted read once,
every output byte written once.  Each kernel's count lives in its own
metric file (port_bench/metrics/<kernel>_roofline.py, least_work); this
module holds what they share.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from port_bench.reference.graph import Graph
from port_bench.reference.problem import design_matrix

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: HBM3 bytes/s, and
# FLOP/s outside the tensor cores by dtype
PEAKS = {"H100 80GB HBM3": {"hbm": 3.35e12, "float32": 67e12,
                            "float64": 34e12}}


def peaks(device_name: str) -> Optional[dict]:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def esize(dtype: str) -> int:
    return {"float32": 4, "float64": 8}[dtype]


def q_structure(g: Graph) -> Tuple[int, int]:
    """Structural non-zeros of Q = A^T A (A the design matrix, every
    entry by its absolute value, so nothing cancels): (its upper
    triangle, all of it)."""
    A = design_matrix(g)
    A.data = np.abs(A.data)
    Q = (A.T @ A).tocsr()
    Q.sum_duplicates()
    upper = int(np.count_nonzero(Q.indices >= np.repeat(
        np.arange(Q.shape[0]), np.diff(Q.indptr))))
    return upper, int(Q.nnz)


def least_seconds(bytes_flops, dtype: str, peak: dict) -> float:
    nbytes, flops = bytes_flops
    return max(nbytes / peak["hbm"], flops / peak[dtype])
