"""The traced run's readings: torch.profiler over whole solves at the start
of the window, reduced to device busy time, kernel time by name, the
longest idle gaps with what the host was doing in each, and the flat_ops
launches by mode.

Only runs with ``--trace 1`` use this module; the runs that give the
end-to-end metrics trace nothing.
"""

from __future__ import annotations

import re
import weakref
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

# traced window: whole solves from the window's start until this many
# seconds have passed (at least one solve); the rest of the window runs
# untraced
TRACE_SECONDS = 1.0


def flat_mode(kernel: str, args) -> str:
    """Which work a launch of csrc/flat_ops.cu does, from its argument
    block (tiled._launch_flat's FlatArgs: X, HV/V, eta, Ssym, s_inner,
    pose_inv, sph_inv, lmk_inv, out, Ssym_out, s_inner_out, sizes...)."""
    if kernel == "flat_precond":
        return "precond"
    if args[2]:
        return "rhess"
    if args[9]:
        return "setup"
    return "project"


class LaunchTap:
    """Counts the launches of csrc/flat_ops.cu by mode (flat_mode); a
    launch recorded into a CUDA graph counts once per replay of that
    graph.  Installed before set-up, so that the graphs the warm-up
    captures are counted too."""

    def __init__(self):
        self.counts: Counter = Counter()
        self._capturing: Counter = Counter()
        self._per_graph = weakref.WeakKeyDictionary()

    def install(self):
        from dcora_tpu_torch.core import rtr, tiled

        tap = self
        real_launch = tiled._launch_flat
        real_record, real_replay = rtr.TCGGraph._record, rtr.TCGGraph.replay

        def launch(kernel, X, args):
            key = flat_mode(kernel, args)
            if torch.cuda.is_available() and \
                    torch.cuda.is_current_stream_capturing():
                tap._capturing[key] += 1
            else:
                tap.counts[key] += 1
            return real_launch(kernel, X, args)

        def record(graph, body):
            before = Counter(tap._capturing)
            real_record(graph, body)
            tap._per_graph[graph] = tap._capturing - before

        def replay(graph):
            tap.counts.update(tap._per_graph.get(graph, {}))
            return real_replay(graph)

        tiled._launch_flat = launch
        rtr.TCGGraph._record = record
        rtr.TCGGraph.replay = replay

    def snapshot(self) -> Counter:
        return Counter(self.counts)


class Profile:
    """One torch.profiler session over the traced solves."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def reduce(self) -> "Reduced":
        """The profile's device intervals and host ops, read from the raw
        kineto events (building the profiler's EventList takes ~80 us an
        event, minutes for a traced second of the tile path)."""
        dev, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            start, end = e.start_ns() * 1e-3, e.end_ns() * 1e-3
            (dev if e.device_type() == cuda else host).append(
                (start, end, e.name()))
        return Reduced(dev, host)


def _merge(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Reduced:
    """Device activity and host ops of one profile (times in us)."""

    def __init__(self, dev, host):
        self.dev = dev
        self.host = sorted(host)
        self.busy = _merge([(s, e) for s, e, _ in dev])
        self.by_name: Dict[str, Tuple[int, float]] = {}
        for s, e, name in dev:
            c, t = self.by_name.get(name, (0, 0.0))
            self.by_name[name] = (c + 1, t + (e - s) * 1e-6)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def kernel(self, pattern: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name matches
        the regular expression `pattern` as a whole word."""
        rx = re.compile(rf"\b{pattern}\b")
        n, t = 0, 0.0
        for name, (c, s) in self.by_name.items():
            if rx.search(name):
                n, t = n + c, t + s
        return n, t

    def top_ops(self, k: int = 10) -> List[list]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name, s] for name, (_, s) in ops]

    def _host_at(self, t: float) -> str:
        """The innermost host op running at time t, else the first that
        starts after it ("before ..."): the gap is then the host's own
        Python or library code, outside any traced op."""
        best: Optional[Tuple[float, str]] = None
        for s, e, name in self.host:
            if s > t:
                return best[1] if best else f"before {name}"
            if e >= t and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else "host: no traced op"

    def idle_gaps(self, k: int = 10) -> List[list]:
        gaps = [(b[0] - a[1], a[1], b[0])
                for a, b in zip(self.busy, self.busy[1:])]
        gaps.sort(reverse=True)
        return [[self._host_at(0.5 * (s + e)), g * 1e-6]
                for g, s, e in gaps[:k]]


class Reading:
    """What a per-layer metric reads: the profile of the traced window,
    its wall seconds, the flat_ops launches by mode within it, the
    program's per-solve stage seconds (of the untraced solves after it),
    the problem (the reference's Graph) and the rank its kernels run at
    (both None where the entry has no one problem and rank), the entry's
    dtype, the card's peaks (None for an unknown card) and the entry's
    name."""

    def __init__(self, reduced: Reduced, window_s: float,
                 flat_modes: Counter, stages: List[dict], graph,
                 rank: Optional[int], dtype: str, peak: Optional[dict],
                 mix: str):
        self.reduced = reduced
        self.window_s = window_s
        self.flat_modes = flat_modes
        self.stages = stages
        self.graph = graph
        self.rank = rank
        self.dtype = dtype
        self.peak = peak
        self.mix = mix
