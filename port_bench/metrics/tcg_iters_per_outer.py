"""tCG iterations that did work per RTR outer iteration: the port's
counters "tcg.useful" over "rtr.outer", over every solve of the run (the
same work each), in the RTR cells."""

from port_bench import program


def read(t):
    c = program.counters() if t.mix == "rtr" else None
    if not c or not c.get("rtr.outer"):
        return None
    return c.get("tcg.useful", 0) / c["rtr.outer"]
