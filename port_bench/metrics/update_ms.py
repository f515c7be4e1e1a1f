"""Milliseconds of a parallel RBCD round's block update (the stacked
one-accepted-step RTR of every agent, with its layout conversions; it
waits for the device once a try): the wall of the port's "rbcd.update"
spans per "rbcd.round" span, over the traced window, in the parallel RBCD
cells."""

from port_bench import program


def read(t):
    rounds = program.intervals(t, "rbcd.round") if t.mix == "rbcd" else []
    if not rounds:
        return None
    spans = program.intervals(t, "rbcd.update")
    return 1e-3 * sum(e - s for s, e in spans) / len(rounds)
