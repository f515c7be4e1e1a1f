"""Seconds of the staircase's solve stage (mixed-precision RTR,
StaircaseResult.stage_seconds["solve"]) per certified solve, averaged over
the traced solves."""


def read(t):
    v = [s["solve"] for s in t.stages if "solve" in s]
    return sum(v) / len(v) if v else None
