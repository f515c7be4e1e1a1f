"""Share of the wall inside the port's "rtr.tcg" spans (a tCG call, from
its first issued iteration to its last probe) in which no operation ran
on the card, over the traced window, in the RTR cells."""

from port_bench import program


def read(t):
    spans = program.intervals(t, "rtr.tcg") if t.mix == "rtr" else []
    wall = sum(e - s for s, e in spans)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - program.busy_within(t.reduced.busy, spans) / wall)
