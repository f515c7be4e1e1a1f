"""Seconds of rtr_fast's exact f64 edge-path phase in the staircase's
solve stage per certified solve (its retries included): the span
"solve/edge" of StaircaseResult.stage_seconds, averaged over the untraced
solves after the traced window."""

from port_bench import program


def read(t):
    return program.stage_part(t, "solve", "edge")
