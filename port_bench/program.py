"""What the port itself records, for the per-layer metrics that read it:
the parts of a stage in the solves' stage seconds, the program's spans in
the traced window (host events named "dcora.<span>" on the profiler's
clock), and the program's counters.  A program without them (an older
port) gives None, so that a metric that reads them is left out of the
line."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def stage_part(t, stage: str, part: str) -> Optional[float]:
    """Seconds of stage_seconds["<stage>/<part>"] per solve, averaged over
    the solves that ran the stage (a solve that ran it without the part
    counts 0); None when no solve has the part."""
    key = f"{stage}/{part}"
    ran = [s for s in t.stages if stage in s]
    if not any(key in s for s in ran):
        return None
    return sum(s.get(key, 0.0) for s in ran) / len(ran)


def counters() -> Optional[Dict[str, int]]:
    """The port's process-wide counters (utils.timing.counters), over
    every solve the run made; None when the port keeps none."""
    try:
        from dcora_tpu_torch.utils.timing import counters as read
    except ImportError:
        return None
    return read()


def intervals(t, name: str) -> List[Tuple[float, float]]:
    """(start, end) in us of the traced window's spans `name`."""
    full = "dcora." + name
    return [(s, e) for s, e, n in t.reduced.host if n == full]


def busy_within(busy, spans: List[Tuple[float, float]]) -> float:
    """Microseconds of the merged, sorted device intervals `busy` that lie
    inside the sorted, disjoint intervals `spans`."""
    total, i = 0.0, 0
    for s, e in spans:
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            total += min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return total
