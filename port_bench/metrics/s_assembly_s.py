"""Seconds of the host's scipy assembly of S = Q - Lambda per certified
solve: the span "certify/assemble" of StaircaseResult.stage_seconds,
averaged over the untraced solves after the traced window."""

from port_bench import program


def read(t):
    return program.stage_part(t, "certify", "assemble")
