"""Kernel 1 (csrc/spmm_sym.cu, W = X Q) against its roofline: launches x
the least time of one product (least_work) over the launches' summed
device time."""

from port_bench import roofline


def least_work(g, r: int, esize: int):
    """(bytes, operations) of one product W = X Q at rank r: Q's
    structural upper triangle read once, X (r x k) read once, W written
    once; a multiply-add per structural non-zero of Q and row."""
    q_upper, q_full = roofline.q_structure(g)
    return esize * (q_upper + 2 * r * g.k), 2 * r * q_full


def read(t):
    n, secs = t.reduced.kernel("spmm_sym_kernel")
    if not n or t.peak is None or t.graph is None:
        return None
    work = least_work(t.graph, t.rank, roofline.esize(t.dtype))
    return 100.0 * n * roofline.least_seconds(work, t.dtype, t.peak) / secs
