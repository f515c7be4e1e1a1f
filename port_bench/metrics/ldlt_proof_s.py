"""Seconds of the host's LDL^T factorizations per certified solve (the
proof of S + eta I, and any inertia bisection's): the span "certify/ldlt"
of StaircaseResult.stage_seconds, averaged over the untraced solves after
the traced window."""

from port_bench import program


def read(t):
    return program.stage_part(t, "certify", "ldlt")
