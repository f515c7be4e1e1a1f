"""Milliseconds of the central check of a parallel RBCD solve (the cost
and the Riemannian gradient norm over every pose at float64, to their
read-back): the wall of the port's "rbcd.evaluate" spans per span, over
the traced window, in the parallel RBCD cells."""

from port_bench import program


def read(t):
    spans = program.intervals(t, "rbcd.evaluate") if t.mix == "rbcd" \
        else []
    if not spans:
        return None
    return 1e-3 * sum(e - s for s, e in spans) / len(spans)
