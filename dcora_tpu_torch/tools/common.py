"""Helpers shared by the port's tools and chip_smoke.py: the card's identity,
CUDA-event timing, the SpMM's, the BTD solve's, the flat ops' and the
LDL^T's bounds, the SpMM's
library yardstick, the default generated 10,648-pose grid, the generated
RA-SLAM sets and the edge path's tCG solve on them.

Every measurement here needs a CUDA device; :func:`require_cuda` refuses to
go on without one (the tools never fall back to the CPU).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

LAUNCHES = 100  # back-to-back launches per timing

# nominal HBM bandwidth in GB/s by device name (NVIDIA data sheets); a
# roofline drawn from these is nominal, not measured
NOMINAL_HBM_GBS = (("H100 80GB HBM3", 3350.0), ("H100 NVL", 3900.0),
                   ("H100 PCIe", 2000.0), ("H200", 4800.0))
# peak FLOP/s of one H100 SXM outside the tensor cores (NVIDIA data sheet,
# 700 W): the SpMM uses no matrix instruction
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# peak f64 FLOP/s of one H100 SXM on the tensor cores (DMMA; NVIDIA data
# sheet, 700 W): csrc/ldlt.cu's panel updates are mma.sync f64
PEAK_DMMA_F64 = 67e12


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


def platform(device) -> str:
    """The records' "platform": the card's name and power limit for a
    CUDA device, else "cpu"."""
    return card() if torch.device(device).type == "cuda" else "cpu"


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


def device_ms(fn: Callable, n: int = 20, profiler: bool = True) -> float:
    """Device time per call of fn: the durations of the CUDA kernels and
    memsets that torch.profiler records over n calls, summed, over n.
    Unlike time_ms it leaves out the host's launch overhead and the gaps
    it leaves between kernels.  Now and then a profile holds no CUDA event
    at all, and three in a row have been seen empty; then (or with
    profiler=False) it returns queued_ms(fn, n), which reads 1-2 us
    higher, and says so on stderr."""
    fn()
    torch.cuda.synchronize()
    if profiler:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        for _ in range(3):
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            us = sum(e.time_range.end - e.time_range.start
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
            if us > 0:
                return us / n * 1e-3
        print("device_ms: torch.profiler recorded no device time; timed "
              "with CUDA events behind a sleep (queued_ms) instead",
              file=sys.stderr, flush=True)
    return queued_ms(fn, n)


def queued_ms(fn: Callable, n: int = 20) -> float:
    """Milliseconds per call of fn with the host's launch overhead left
    out: a sleep kernel holds the stream while the host issues n calls
    behind a start event, so the events time the device's work and the
    gaps between its kernels (1-2 us each), not the host's.
    The sleep is lengthened until the host has issued every call before it
    ends; a fn that waits for the device never gets there, and then the
    last time is returned, host gaps included, with a note on stderr."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 20  # ~0.5 ms at the H100's clock
    for _ in range(6):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        queued = not start.query()  # the sleep still holds the stream
        stop.synchronize()
        if queued:
            break
        cycles *= 4
    else:
        print("queued_ms: the calls were not all issued within the sleep; "
              "the time includes the host's gaps", file=sys.stderr,
              flush=True)
    return start.elapsed_time(stop) / n


def state_sha256(X) -> str:
    """SHA-256 of a state's bytes (each tensor on the host, in order)."""
    h = hashlib.sha256()
    for x in X:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def symmetric_csr(Q, kpad: int) -> Tuple[torch.Tensor, int]:
    """The full symmetric [kpad, kpad] Q of a TiledQ in flat order, both
    triangles of every stored tile, as a torch sparse CSR tensor (int32
    indices) at the tiles' dtype and device; and the count of stored
    non-zeros (the upper tiles' entries, what the SpMM must read of Q).  It
    is the operand of the library yardstick torch.sparse.mm(Q, X^T), which
    the port never calls."""
    tiles = Q.tiles.cpu().numpy()
    trow, tcol = Q.tile_rows.cpu().numpy(), Q.tile_cols.cpu().numpy()
    T = tiles.shape[-1]
    t, i, j = np.nonzero(tiles)
    r, c, v = trow[t] * T + i, tcol[t] * T + j, tiles[t, i, j]
    off = trow[t] != tcol[t]
    r, c = np.concatenate([r, c[off]]), np.concatenate([c, r[off]])
    v = np.concatenate([v, v[off]])
    order = np.lexsort((c, r))
    crow = np.zeros(kpad + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=kpad), out=crow[1:])
    dev = Q.tiles.device
    csr = torch.sparse_csr_tensor(
        torch.as_tensor(crow.astype(np.int32), device=dev),
        torch.as_tensor(c[order].astype(np.int32), device=dev),
        torch.as_tensor(v[order], dtype=Q.tiles.dtype, device=dev),
        size=(kpad, kpad), check_invariants=True)
    return csr, len(t)


def spmm_bound_ms(stored_nnz: int, full_nnz: int, r_pad: int, kpad: int,
                  dtype: torch.dtype, hbm_gbs: float) -> Tuple[float, str]:
    """The least time one product W = X Q could take on the card, and what
    sets it: the larger of the bytes it must move (Q's stored non-zeros
    read once, X [r_pad, kpad] read once, W written once) over the HBM
    rate, and its operations (2 per non-zero of the full Q per row) over
    the peak FLOP/s outside the tensor cores."""
    esize = torch.empty((), dtype=dtype).element_size()
    bytes_ms = (stored_nnz + 2 * r_pad * kpad) * esize / (hbm_gbs * 1e6)
    ops_ms = 2.0 * full_nnz * r_pad / PEAK_FLOPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                            "operations")


def load_graph(path: str, r: int):
    """The single-robot graph of a .g2o file (PGO) or of a .pyfg file (the
    global RA-SLAM graph of every robot's measurements, as the RA driver
    builds it), at rank r."""
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.io import read_g2o_file, read_pyfg_file
    from dcora_tpu_torch.io.remap import get_global_measurements
    from dcora_tpu_torch.types import GraphType

    if path.endswith(".pyfg"):
        ds = read_pyfg_file(path)
        g = LocalGraph(0, r, ds.dim, GraphType.RangeAidedSLAMGraph)
        g.set_measurements(get_global_measurements(ds).relative_measurements)
        return g
    ds = read_g2o_file(path)
    g = LocalGraph(0, r, ds.dim)
    g.set_measurements(ds.pose_pose_measurements)
    return g


def q_stats(TP) -> dict:
    """What a TiledProblem's Q holds: tile columns, stored upper tiles and
    their non-zeros, and kernel 1's strip CSR (strips, non-empty sub-blocks,
    MB of its values and indices at the tiles' dtype)."""
    S = TP.Q.strips
    return dict(nt=TP.meta.nt, k=TP.meta.k,
                stored_tiles=int(TP.Q.tiles.shape[0]),
                stored_nnz=int(torch.count_nonzero(TP.Q.tiles)),
                strips=int(S.ptr.numel()) - 1, blocks=int(S.src.numel()),
                strip_mb=sum(t.numel() * t.element_size() for t in S) / 1e6)


def default_grid(directory: str) -> str:
    """Generate the 10,648-pose grid (generate_large_scale_g2o at
    target_poses=10_000, the certified slice's and the bench's default
    input) into `directory`; returns its path."""
    from dcora_tpu_torch import datasets

    return datasets.generate_large_scale_g2o(
        os.path.join(directory, "grid10k.g2o"), target_poses=10_000)


# the generated RA-SLAM sets of the port's RA cells (tests/data/
# torch_port_ra_reference.json): five robots in parallel lanes, four
# landmarks, a range to every aligned pose of the next robot and from every
# landmark, rot / trans / range noise 0.01 / 0.01 / 0.01 (at 0.05 / 0.02 /
# 0.02 the 500-pose set's staircase climbs to rank 11 and its first rank
# alone outlasts the smoke run's time on the card: PERF.md).
# poses_per_robot 100 is ra500, 1950 ra10k (9,750 poses, 7,820 ranges:
# tiers.pyfg's size)
RA_KW = dict(num_robots=5, num_landmarks=4, range_prob=1.0, rot_noise=0.01,
             trans_noise=0.01, range_noise=0.01, seed=3)


def ra_set(directory: str, poses_per_robot: int) -> str:
    """Generate the RA-SLAM set with `poses_per_robot` poses per robot
    (RA_KW) into `directory`; returns its path."""
    from dcora_tpu_torch import datasets

    return datasets.generate_ra_slam_pyfg(
        os.path.join(directory, f"ra{5 * poses_per_robot}.pyfg"),
        poses_per_robot=poses_per_robot, **RA_KW)


class EdgeTCG(NamedTuple):
    """The edge path's tCG solve of an RA set at rank r from the odometry
    init, through its CUDA graph (rtr.TCGGraph): solve() runs one solve of
    up to `iters` iterations from the same start."""

    g: object               # the set's LocalGraph
    P: object               # its ProblemData on the card
    X: object               # the odometry init, on the card
    graph: object           # rtr.TCGGraph
    solve: Callable


def edge_tcg(path: str, r: int = 3, iters: int = 200) -> EdgeTCG:
    """EdgeTCG of the .pyfg set at `path` on the card."""
    from dcora_tpu_torch.core import rtr
    from dcora_tpu_torch.drivers.single_robot_raslam import (
        odometry_init_global,
    )
    from dcora_tpu_torch.io import read_pyfg_file
    from dcora_tpu_torch.io.remap import get_global_measurements
    from dcora_tpu_torch.solvers import make_preconditioner

    ds = read_pyfg_file(path)
    g = load_graph(path, r)
    P = g.problem_data(device="cuda")
    M = make_preconditioner(g, P)
    X = odometry_init_global(ds, get_global_measurements(ds)).to("cuda")
    egrad = rtr.RA_BACKEND.applyQ(P, X)
    grad = rtr.RA_BACKEND.tangent(P, X, egrad)
    flat = rtr.tmap(torch.zeros_like, egrad)
    radius = torch.tensor(1e8, dtype=torch.float64, device="cuda")
    graph = rtr.TCGGraph(rtr.RA_BACKEND, P, M, iters)

    def solve():
        return rtr.truncated_cg(P, X, grad, flat, M, radius, iters, 1e-12,
                                1.0, graph=graph)

    return EdgeTCG(g, P, X, graph, solve)


def btd_bound_ms(nt: int, T: int, r_pad: int, dtype: torch.dtype,
                 hbm_gbs: float) -> Tuple[float, str]:
    """The least time one block-tridiagonal solve (tiled._precondition_btd)
    could take on the card, and what sets it: the larger of its bytes (the
    factors L~ and inv(S), [nt, T, T] each, and V read once, the result
    written once) over the HBM rate, and its operations (2 * nt products
    of [r_pad, T] by [T, T] in the substitutions and nt in the diagonal
    solve, 2 * r_pad * T^2 each) over the peak FLOP/s outside the tensor
    cores."""
    esize = torch.empty((), dtype=dtype).element_size()
    bytes_ms = (2 * nt * T * T + 2 * r_pad * nt * T) * esize / (hbm_gbs * 1e6)
    ops_ms = 3.0 * nt * 2.0 * r_pad * T * T / PEAK_FLOPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                            "operations")


def ldlt_ops(an) -> float:
    """The f64 operations of the supernodal LDL^T of an analysis
    (core.ldlt.Analysis): the sum over L's columns of the squared count of
    their entries below the diagonal, (f - 1 - j)^2 for column j of a
    supernode with f rows in its front (each such column's rank-1 update
    of the lower triangle below it, a multiply-add per entry)."""
    f = an.size.astype(np.float64)
    lo = f - an.width  # the smallest count, at a supernode's last column

    def squares(m):  # 0^2 + 1^2 + ... + (m - 1)^2
        return (m - 1) * m * (2 * m - 1) / 6.0

    return float((squares(f) - squares(lo)).sum())


def ldlt_bound_ms(an, hbm_gbs: float) -> Tuple[float, str]:
    """The least time one factorization of csrc/ldlt.cu could take on the
    card, and what sets it: the larger of its operations (ldlt_ops) over
    the f64 tensor cores' peak and L's entries (an.nnz_L, f64) written once
    over the HBM rate."""
    ops_ms = ldlt_ops(an) / PEAK_DMMA_F64 * 1e3
    bytes_ms = an.nnz_L * 8 / (hbm_gbs * 1e6)
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                            "operations")


def flat_bound_ms(kernel: str, meta, r_pad: int, agents: int,
                  dtype: torch.dtype, hbm_gbs: float) -> Tuple[float, str]:
    """The least time one launch of a kernel of csrc/flat_ops.cu could take
    on the card, and what sets it: the larger of its bytes over the HBM rate
    and its operations over the peak FLOP/s outside the tensor cores.

    flat_rhess (tiled.flat_rhess with the Weingarten term) reads X, HV and
    eta ([r_pad, A kpad] each), Ssym [A, n, d, d] and s_inner [A, l] once
    and writes one [r_pad, A kpad]; per row it does 3 d^2 multiply-adds on
    each pose (the Weingarten term, the Gram, the projection) and 3 on each
    sphere column.  flat_precond reads X, V, pose_inv [A, n, dh, dh],
    sph_inv and lmk_inv once and writes one array; per row dh^2 + 2 d^2
    multiply-adds on each pose, 3 on each sphere column and 1 on each
    landmark."""
    esize = torch.empty((), dtype=dtype).element_size()
    m = meta
    flat = r_pad * agents * m.kpad
    if kernel == "flat_rhess":
        nbytes = 4 * flat + agents * (m.n * m.d * m.d + m.l)
        fma = m.n * 3 * m.d * m.d + 3 * m.l
    elif kernel == "flat_precond":
        nbytes = 3 * flat + agents * (m.n * m.dh * m.dh + m.l + m.b)
        fma = m.n * (m.dh * m.dh + 2 * m.d * m.d) + 3 * m.l + m.b
    else:
        raise ValueError(f"flat_bound_ms: unknown kernel {kernel!r}")
    bytes_ms = nbytes * esize / (hbm_gbs * 1e6)
    ops_ms = 2.0 * fma * r_pad * agents / PEAK_FLOPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                            "operations")


def count_calls(module, name: str, key: Callable = lambda *args: 0):
    """Count the calls of module.<name> by key(*args), as the kernels count
    their launches: a call issued eagerly counts now, one recorded in a
    CUDA graph (rtr.TCGGraph) once per replay of that graph.  Returns (a
    collections.Counter, a function that undoes the patching)."""
    from collections import Counter

    from dcora_tpu_torch.core import rtr

    real = getattr(module, name)
    real_record, real_replay = rtr.TCGGraph._record, rtr.TCGGraph.replay
    counts, captured, mine = Counter(), Counter(), object()

    def call(*args):
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            captured[key(*args)] += 1
        else:
            counts[key(*args)] += 1
        return real(*args)

    def record(graph, body):
        before = Counter(captured)
        real_record(graph, body)
        if not hasattr(graph, "counted_calls"):
            graph.counted_calls = {}
        graph.counted_calls[mine] = captured - before

    def replay(graph):
        counts.update(getattr(graph, "counted_calls", {}).get(mine, {}))
        return real_replay(graph)

    def restore():
        setattr(module, name, real)
        rtr.TCGGraph._record, rtr.TCGGraph.replay = real_record, real_replay

    setattr(module, name, call)
    rtr.TCGGraph._record, rtr.TCGGraph.replay = record, replay
    return counts, restore


def count_products():
    """Count tile products (calls of tiled.apply_tiled; count_calls):
    returns (a Counter whose [0] is the count, restore)."""
    from dcora_tpu_torch.core import tiled

    return count_calls(tiled, "apply_tiled")
