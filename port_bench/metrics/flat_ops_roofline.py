"""csrc/flat_ops.cu's two kernels against their roofline, summed: each
flat_rhess launch at the least work of its mode (the tCG's Hessian, a
projection or the Weingarten set-up, in the proportions the launch tap
counted), each flat_precond launch at the per-pose Jacobi solve with the
projection; over the launches' summed device time."""

from port_bench import roofline


def least_work(g, r: int, esize: int, mode: str):
    """(bytes, operations) of one launch at rank r over the state's k
    columns: P_X(HV - W(eta)) ("rhess"), P_X(V) ("project"), the
    Weingarten terms sym(Y^T G), <s, g> ("setup"), or the per-pose
    Jacobi solve with the projection ("precond").  The projection reads
    X's rotation and sphere columns, r (d n + l) of them."""
    d, n, l = g.d, g.n, g.l  # noqa: E741
    d2 = n * d * d
    rk = r * g.k
    rs = r * (d * n + l)
    if mode == "rhess":
        return esize * (2 * rk + 2 * rs + d2 + l), 2 * r * (3 * d2 + 3 * l)
    if mode == "project":
        return esize * (2 * rk + rs), 2 * r * (2 * d2 + 2 * l)
    if mode == "setup":
        return esize * (2 * rs + d2 + l), 2 * r * (d2 + l)
    if mode == "precond":
        dh = d + 1
        return (esize * (2 * rk + rs + n * dh * dh + l + g.b),
                2 * r * (n * (dh * dh + 2 * d * d) + 3 * l + g.b))
    raise ValueError(f"flat_ops: unknown mode {mode!r}")


def read(t):
    n_r, s_r = t.reduced.kernel("flat_rhess")
    n_p, s_p = t.reduced.kernel("flat_precond")
    modes = {m: c for m, c in t.flat_modes.items() if m != "precond"}
    if not (n_r or n_p) or t.peak is None or t.graph is None \
            or (n_r and not modes):
        return None
    es = roofline.esize(t.dtype)

    def least(mode):
        return roofline.least_seconds(least_work(t.graph, t.rank, es, mode),
                                      t.dtype, t.peak)

    bound = 0.0
    if n_r:
        bound += n_r * sum(c * least(m) for m, c in modes.items()) \
            / sum(modes.values())
    if n_p:
        bound += n_p * least("precond")
    return 100.0 * bound / (s_r + s_p)
