"""Milliseconds of an RTR outer iteration outside its tCG call (the
retraction, the cost and the acceptance test, the gradient and the flag
read): the wall of the port's "rtr.outer" spans less that of the "rtr.tcg"
spans, per outer span, over the traced window, in the RTR cells."""

from port_bench import program


def read(t):
    outer = program.intervals(t, "rtr.outer") if t.mix == "rtr" else []
    if not outer:
        return None
    tcg = program.intervals(t, "rtr.tcg")
    rest = sum(e - s for s, e in outer) - sum(e - s for s, e in tcg)
    return 1e-3 * rest / len(outer)
