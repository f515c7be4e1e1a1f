"""Helpers shared by the port's tools and chip_smoke.py: the card's identity,
CUDA-event timing, and the default generated 10,648-pose grid.

Every measurement here needs a CUDA device; :func:`require_cuda` refuses to
go on without one (the tools never fall back to the CPU).
"""

from __future__ import annotations

import os
import subprocess
from typing import Callable, List, Sequence

import torch

LAUNCHES = 100  # back-to-back launches per timing

# nominal HBM bandwidth in GB/s by device name (NVIDIA data sheets); a
# roofline drawn from these is nominal, not measured
NOMINAL_HBM_GBS = (("H100 80GB HBM3", 3350.0), ("H100 NVL", 3900.0),
                   ("H100 PCIe", 2000.0), ("H200", 4800.0))


def require_cuda(tool: str):
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: no CUDA device; this tool measures the "
                           "card and does not run on the CPU")


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def nominal_hbm_gbs(name: str):
    """The data-sheet HBM bandwidth of the named card, or None."""
    for key, gbs in NOMINAL_HBM_GBS:
        if key in name:
            return gbs
    return None


def time_ms(fn: Callable, n: int = LAUNCHES) -> float:
    """Milliseconds per call of fn: CUDA events around n calls issued back
    to back, after a warm-up."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def time_turns_ms(fns: Sequence[Callable], rounds: int = 3,
                  n: int = LAUNCHES) -> List[float]:
    """Median per-call ms of each fn, timed in turns on the same inputs
    (forward order, then reverse order, ...)."""
    ts: List[List[float]] = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in range(rounds):
        for k in (order if i % 2 == 0 else order[::-1]):
            ts[k].append(time_ms(fns[k], n))
    return [sorted(t)[rounds // 2] for t in ts]


def device_ms(fn: Callable, n: int = 20) -> float:
    """Device time per call of fn: the durations of the CUDA kernels and
    memsets that torch.profiler records over n calls, summed, over n.
    Unlike time_ms it leaves out the host's launch overhead and the gaps
    it leaves between kernels."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / n * 1e-3


def default_grid(directory: str) -> str:
    """Generate the 10,648-pose grid (generate_large_scale_g2o at
    target_poses=10_000, the certified slice's and the bench's default
    input) into `directory`; returns its path."""
    from dcora_tpu_torch import datasets

    return datasets.generate_large_scale_g2o(
        os.path.join(directory, "grid10k.g2o"), target_poses=10_000)
