"""Seconds of the staircase's certify stage (Lanczos, then the host LDL^T
proof; StaircaseResult.stage_seconds["certify"]) per certified solve,
averaged over the traced solves."""


def read(t):
    v = [s["certify"] for s in t.stages if "certify" in s]
    return sum(v) / len(v) if v else None
