"""tCG iterations that did work per agent update of a parallel RBCD
round (every try of the agent's step counted): the port's counters
"tcg.useful" over "rbcd.agent_updates", over every solve of the run (the
same work each), in the parallel RBCD cells."""

from port_bench import program


def read(t):
    c = program.counters() if t.mix == "rbcd" else None
    if not c or not c.get("rbcd.agent_updates"):
        return None
    return c.get("tcg.useful", 0) / c["rbcd.agent_updates"]
