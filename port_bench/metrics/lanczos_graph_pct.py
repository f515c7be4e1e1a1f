"""Share of the Lanczos steps that replayed a captured CUDA graph: 100
"lanczos.graph_steps" / "lanczos.steps" of the port's counters, over every
solve of the run, in the certified-solve cells.  None where the port counts
no graph steps (a port that issues every step from the host)."""

from port_bench import program


def read(t):
    c = program.counters() if t.mix == "certify" else None
    if not c or not c.get("lanczos.steps") or "lanczos.graph_steps" not in c:
        return None
    return 100.0 * c["lanczos.graph_steps"] / c["lanczos.steps"]
