"""Lanczos steps per certification (fast_verification call): the port's
counters "lanczos.steps" over "certify.calls", over every solve of the
run, in the certified-solve cells."""

from port_bench import program


def read(t):
    c = program.counters() if t.mix == "certify" else None
    if not c or not c.get("certify.calls"):
        return None
    return c.get("lanczos.steps", 0) / c["certify.calls"]
