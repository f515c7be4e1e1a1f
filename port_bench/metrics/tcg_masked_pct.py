"""Share of the tCG iterations issued that were masked no-ops (issued
after the solve converged, before the host saw it): 100 (issued - useful)
/ issued of the port's counters "tcg.issued" and "tcg.useful", over every
solve of the run, in the RTR cells."""

from port_bench import program


def read(t):
    c = program.counters() if t.mix == "rtr" else None
    if not c or not c.get("tcg.issued"):
        return None
    return 100.0 * (c["tcg.issued"] - c.get("tcg.useful", 0)) \
        / c["tcg.issued"]
