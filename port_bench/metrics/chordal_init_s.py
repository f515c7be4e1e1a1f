"""Seconds of the PGO driver's chordal initialization per certified solve
(its result["init_s"]), averaged over the traced solves."""


def read(t):
    v = [s["init_s"] for s in t.stages if "init_s" in s]
    return sum(v) / len(v) if v else None
