"""Wall-clock phase timing (reference: SimpleTimer, DCORA_utils.h:35-60,
DCORA_utils.cpp:127-145) plus a per-phase accumulator matching the Graph's
ms_construct_Q_/G_/precon_ bookkeeping (Graph.h:468-471), and the port's
spans and counters.

Counterpart of ``dcora_tpu.utils.timing``.  CUDA work is asynchronous, so
``toc`` and ``phase`` synchronize the device of every CUDA tensor in the
``block_on`` pytree (tensors, or tuples, lists and dicts of them) before
reading the clock, and timings measure completed device work rather than
the enqueue.  CPU tensors need nothing.

``span(name, into)`` marks a stretch of the host's work: while a torch
profiler records, as a record function "dcora." + name, a host event on
the profiler's own clock beside the kernels it issues (nesting on the
thread is parentage); given a dict ``into``, it adds its wall seconds
under ``name``.  A span never synchronizes: its seconds are the host's,
and it ends where the host already waits when it should cover device
work.  Its record function has the scope of an operator, not of a user
annotation (torch.profiler.record_function): the profiler draws a user
annotation a second time on the device's timeline, from the first to the
last kernel issued inside it, and a reading of the device's busy time
would count that interval as work.

``count``/``counters``/``reset_counters`` are one process-wide registry of
integer counters; a count given as a tensor is summed on its device and
read only by ``counters()``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _profiler

_record = torch._C._profiler._RecordFunctionFast


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _block(tree) -> None:
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class SimpleTimer:
    """tic/toc in milliseconds (reference: SimpleTimer)."""

    def __init__(self):
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, block_on=None) -> float:
        """Elapsed ms since tic(); first synchronizes block_on's devices."""
        assert self._t0 is not None, "toc() before tic()"
        _block(block_on)
        ms = (time.perf_counter() - self._t0) * 1e3
        self._t0 = None
        return ms


class PhaseTimer:
    """Accumulates wall-clock per named phase.

    >>> pt = PhaseTimer()
    >>> with pt.phase("construct_Q"):
    ...     ...
    >>> pt.ms["construct_Q"]
    """

    def __init__(self):
        self.ms: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _block(block_on)
            self.ms[name] += (time.perf_counter() - t0) * 1e3
            self.count[name] += 1

    def report(self) -> str:
        return "\n".join(
            f"{name}: {self.ms[name]:.1f} ms / {self.count[name]} calls"
            for name in sorted(self.ms))


class span:
    """``with span("certify", into=stage_seconds): ...``

    With no profiler recording, a span costs a boolean test and a
    perf_counter pair; ``seconds`` holds its wall seconds once it has
    ended."""

    __slots__ = ("name", "into", "seconds", "_t0", "_rf")

    def __init__(self, name: str, into: Optional[dict] = None):
        self.name, self.into = name, into
        self.seconds: Optional[float] = None
        self._rf = None

    def __enter__(self) -> "span":
        if _profiler._is_profiler_enabled:
            self._rf = _record("dcora." + self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self.into is not None:
            self.into[self.name] = self.into.get(self.name, 0.0) + \
                self.seconds
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


_counts: Dict[str, int] = defaultdict(int)
_device_counts: Dict[tuple, torch.Tensor] = {}


def count(name: str, n=1) -> None:
    """Add n to the counter `name`.  A tensor n (any shape, integer) is
    summed into an accumulator on its own device, with no host wait."""
    if not isinstance(n, torch.Tensor):
        _counts[name] += n
        return
    key = (name, n.device)
    acc = _device_counts.get(key)
    if acc is None:
        acc = _device_counts[key] = torch.zeros((), dtype=torch.int64,
                                                device=n.device)
    acc.add_(n.sum() if n.dim() else n)


def counters() -> Dict[str, int]:
    """Every counter's total since the last reset_counters(); reads the
    device accumulators (a host wait on their devices)."""
    out = dict(_counts)
    for (name, _), acc in _device_counts.items():
        out[name] = out.get(name, 0) + int(acc)
    return out


def reset_counters() -> None:
    _counts.clear()
    _device_counts.clear()
