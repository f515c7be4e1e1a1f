"""Kernel 1 (csrc/spmm_sym.cu) over a fleet of agents (the block-diagonal
strips of every agent's local Q, one launch a product) against its
roofline: launches x the least time of one fleet product (least_work)
over the launches' summed device time, in the parallel RBCD cells."""

import numpy as np

from port_bench import roofline
from port_bench.reference.problem import design_matrix


def least_work(g, r: int, esize: int):
    """(bytes, operations) of one fleet product W_a = X_a Q_aa for every
    agent at once at rank r: each agent's Q_aa (A's columns of its poses,
    g.robots' slices, every entry by its absolute value) read once as its
    structural upper triangle, X over the agents' columns read once, W
    written once; a multiply-add per structural non-zero and row."""
    A = design_matrix(g)
    A.data = np.abs(A.data)
    d, n = g.d, g.n
    upper = full = cols = 0
    for first, count in g.robots:
        c = np.concatenate([np.arange(first * d, (first + count) * d),
                            d * n + g.l + np.arange(first, first + count)])
        Aa = A[:, c]
        Q = (Aa.T @ Aa).tocsr()
        Q.sum_duplicates()
        upper += int(np.count_nonzero(Q.indices >= np.repeat(
            np.arange(Q.shape[0]), np.diff(Q.indptr))))
        full += int(Q.nnz)
        cols += len(c)
    return esize * (upper + 2 * r * cols), 2 * r * full


def read(t):
    if t.mix != "rbcd":
        return None
    n, secs = t.reduced.kernel("spmm_sym_kernel")
    if not n or t.peak is None or t.graph is None:
        return None
    work = least_work(t.graph, t.rank, roofline.esize(t.dtype))
    return 100.0 * n * roofline.least_seconds(work, t.dtype, t.peak) / secs
