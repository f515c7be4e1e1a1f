"""Milliseconds of a parallel RBCD round's exchange (publish, gather,
the fixed states, the linear term G; host time, the device work enqueued):
the wall of the port's "rbcd.exchange" spans per "rbcd.round" span, over
the traced window, in the parallel RBCD cells."""

from port_bench import program


def read(t):
    rounds = program.intervals(t, "rbcd.round") if t.mix == "rbcd" else []
    if not rounds:
        return None
    spans = program.intervals(t, "rbcd.exchange")
    return 1e-3 * sum(e - s for s, e in spans) / len(rounds)
