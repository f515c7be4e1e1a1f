"""Seconds of the certify stage's Lanczos searches per certified solve
(the f32 tiled sweeps and the f64 edge-path sweeps with their Ritz
steps): the span "certify/lanczos" of StaircaseResult.stage_seconds,
averaged over the untraced solves after the traced window."""

from port_bench import program


def read(t):
    return program.stage_part(t, "certify", "lanczos")
