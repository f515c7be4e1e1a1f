"""Share of the traced window's wall in which no operation ran on the
card (the union of the profiler's kernel, copy and set intervals), in the
parallel RBCD cells."""


def read(t):
    if t.mix != "rbcd" or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.reduced.busy_s / t.window_s)
