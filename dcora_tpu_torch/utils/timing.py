"""Wall-clock phase timing (reference: SimpleTimer, DCORA_utils.h:35-60,
DCORA_utils.cpp:127-145) plus a per-phase accumulator matching the Graph's
ms_construct_Q_/G_/precon_ bookkeeping (Graph.h:468-471).

Counterpart of ``dcora_tpu.utils.timing``.  CUDA work is asynchronous, so
``toc`` and ``phase`` synchronize the device of every CUDA tensor in the
``block_on`` pytree (tensors, or tuples, lists and dicts of them) before
reading the clock, and timings measure completed device work rather than
the enqueue.  CPU tensors need nothing.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

import torch


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
