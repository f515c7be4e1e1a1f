"""The roofline's byte and operation counts on problems small enough to
count by hand."""

import numpy as np
import pytest

from port_bench import roofline
from port_bench.reference.graph import Graph

E = np.zeros(0, dtype=np.int64)


def two_poses():
    """Poses 0 -> 1, one edge with a dense rotation and translation."""
    c, s = np.cos([0.3, 0.5, 0.7]), np.sin([0.3, 0.5, 0.7])
    Rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    Ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    Rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    R = Rx @ Ry @ Rz  # no zero entry
    return Graph(d=3, n=2, l=0, b=0, pp_i=np.array([0]), pp_j=np.array([1]),
                 pp_R=R[None], pp_t=np.array([[1.0, 2.0, 3.0]]),
                 pp_kappa=np.array([4.0]), pp_tau=np.array([9.0]),
                 pl_i=E, pl_k=E, pl_t=np.zeros((0, 3)), pl_tau=np.zeros(0),
                 rg_a=E, rg_b=E, rg_q=E, rg_rho=np.zeros(0),
                 rg_prec=np.zeros(0), gt_T=np.zeros((2, 3, 4)),
                 gt_lmk=np.zeros((0, 3)))


def _metric(name):
    from port_bench import harness

    return harness._load("metrics", name)


def test_q_structure_by_hand():
    # columns Y0 (3), Y1 (3), t0, t1.  Upper triangle: Y0-Y0 6, Y1-Y1 3
    # (kappa I only), Y0-Y1 9, Y0-t0 3, Y0-t1 3, t0-t0, t1-t1, t0-t1
    g = two_poses()
    assert g.k == 8
    assert roofline.q_structure(g) == (6 + 3 + 9 + 3 + 3 + 1 + 1 + 1,
                                       2 * 27 - 8)


def test_spmm_sym_count_by_hand():
    least = _metric("spmm_sym_roofline").least_work
    assert least(two_poses(), 5, 4) == (4 * (27 + 2 * 5 * 8), 2 * 5 * 46)


@pytest.mark.parametrize("mode, count", [
    # the Hessian: HV and out over k, X and eta over the 6 rotation
    # columns, Ssym 2 poses x 9; 3 d^2 multiply-adds a pose and row
    ("rhess", (4 * (2 * 40 + 2 * 30 + 18), 2 * 5 * 3 * 18)),
    ("project", (4 * (2 * 40 + 30), 2 * 5 * 2 * 18)),
    ("setup", (4 * (2 * 30 + 18), 2 * 5 * 18)),
    # V in and out, X's rotation columns, a 4x4 inverse a pose
    ("precond", (4 * (2 * 40 + 30 + 2 * 16), 2 * 5 * 2 * (16 + 18))),
])
def test_flat_ops_counts_by_hand(mode, count):
    least = _metric("flat_ops_roofline").least_work
    assert least(two_poses(), 5, 4, mode) == count


def test_least_seconds_takes_the_larger_bound():
    p = {"hbm": 1e12, "float32": 1e13}
    assert roofline.least_seconds((2e12, 1e12), "float32", p) == 2.0
    assert roofline.least_seconds((1e9, 1e14), "float32", p) == 10.0
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["hbm"] == 3.35e12
    assert roofline.peaks("some other card") is None
