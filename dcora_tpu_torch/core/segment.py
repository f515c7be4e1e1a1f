"""Deterministic segment sums (csrc/segment_sum.cu).

Counterpart of the JAX package's ``jax.ops.segment_sum`` on the edge path
(``dcora_tpu/core/problem.py:318``, ``core/init.py``, the DC2-PGO
driver's per-robot gradient norms), which is deterministic on its CPU and
TPU backends.  CUDA's ``index_add_`` adds with float atomics in an order
that changes from run to run, so on the card every edge-path product, and
where the RA staircase lands, changed from run to run.

The sum ``out[row] = sum of contrib[k] over the k with idx[k] == row`` is
taken over a CSR of the index array (:class:`SegmentMap`), built once per
index structure on the host by :func:`build_map`: ``perm``, a stable
argsort of ``idx``, and ``ptr``, the row offsets into it.  The kernel adds
each row's contributions in ascending position, so in a fixed order, with
no atomics.  The contributions come in up to three parts (the edge kinds);
each part is summed from zero and the parts' sums are added in order, as
the port summed them before, one ``index_add_`` per part.

:func:`segment_sums` sums up to three blocks, each its own (contrib, map,
rows), in one launch (``problem.apply_Q``'s rotations, translations and
spheres); :func:`segment_sum` is the one-block call.  On CUDA tensors they
launch the kernel or raise; on CPU tensors they run
:func:`segment_sum_plain` per block, one ``index_add_`` per part
(sequential in position on the CPU), whose order the kernel follows on
every row, so the two give the same bits, and a block gives the same bits
summed alone or beside others.  :func:`build_map` checks the map once
(non-negative indices, int32 positions) and places ``perm`` and ``ptr`` on
the device as contiguous int32; the wrapper checks per call only what a
launch needs to stay inside its buffers.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from dcora_tpu_torch.core import kernels

_FLOATS = (torch.float32, torch.float64)
MAX_BLOCKS = 3
# csrc/segment_sum.cu's Launch: per block (contrib, perm, ptr, out, begin,
# num, nseg, w, part1, part2), then the total, all int64
_LAUNCH = ctypes.c_int64 * (10 * MAX_BLOCKS + 1)


class SegmentMap(NamedTuple):
    """The CSR of an index array whose parts are concatenated.

    Row ``row``'s entries are ``perm[ptr[row]:ptr[row + 1]]`` (positions in
    ``idx``, ascending); rows at or past ``nseg`` have none.  ``bounds``
    holds the positions where parts 1 and 2 begin (``len(idx)`` for a part
    that is absent).  ``idx`` stays on the host: only the plain version
    reads it."""

    idx: torch.Tensor   # i64[K] the index array, on the host
    perm: torch.Tensor  # i32[K] stable argsort of idx, on the map's device
    ptr: torch.Tensor   # i32[nseg + 1], on the map's device
    bounds: Tuple[int, int]

    @property
    def nseg(self) -> int:
        return self.ptr.shape[0] - 1


def build_map(parts: Sequence[Sequence], device="cpu") -> SegmentMap:
    """The SegmentMap of the index arrays of `parts` (at most three parts,
    each a sequence of index arrays or tensors, concatenated in order), on
    the host in numpy, then placed on `device`."""
    if len(parts) > 3:
        raise ValueError(f"at most 3 parts, got {len(parts)}")
    pieces, lengths = [], []
    for part in parts:
        arrs = [np.asarray(a.detach().cpu().numpy()
                           if isinstance(a, torch.Tensor) else a,
                           dtype=np.int64).reshape(-1) for a in part]
        pieces += arrs
        lengths.append(sum(a.shape[0] for a in arrs))
    idx = np.concatenate(pieces) if pieces else np.zeros(0, np.int64)
    K = idx.shape[0]
    if K and idx.min() < 0:
        raise ValueError("segment indices must be non-negative")
    if K >= 2 ** 31:
        raise ValueError(f"{K} contributions do not fit int32 positions")
    nseg = int(idx.max()) + 1 if K else 0
    counts = np.bincount(idx, minlength=nseg)
    ptr = np.zeros(nseg + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    starts = np.cumsum(lengths)[:-1].tolist() if lengths else []
    bounds = tuple(starts + [K] * (2 - len(starts)))

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return SegmentMap(
        idx=torch.from_numpy(idx),
        perm=dev(np.argsort(idx, kind="stable"), torch.int32),
        ptr=dev(ptr, torch.int32),
        bounds=bounds)


def _check(contrib: torch.Tensor, m: SegmentMap, num: int):
    if contrib.shape[0] != m.idx.shape[0]:
        raise ValueError(f"segment_sum: {contrib.shape[0]} contributions, "
                         f"the map indexes {m.idx.shape[0]}")
    if contrib.dtype not in _FLOATS:
        raise TypeError(f"segment_sum: {contrib.dtype} is not float32 or "
                        "float64")
    if num < 0:
        raise ValueError(f"segment_sum: {num} rows")


def segment_sum_plain(contrib: torch.Tensor, m: SegmentMap,
                      num: int) -> torch.Tensor:
    """Plain PyTorch version: one index_add_ per part into zeros, the
    parts' sums added in order; rows [0, num)."""
    _check(contrib, m, num)
    idx = m.idx.to(contrib.device)
    K = contrib.shape[0]
    rows = max(num, m.nseg)
    out, lo = None, 0
    for hi in (*m.bounds, K):
        if hi > lo:
            s = contrib.new_zeros((rows,) + contrib.shape[1:]).index_add_(
                0, idx[lo:hi], contrib[lo:hi])
            out = s if out is None else out + s
        lo = hi
    if out is None:
        out = contrib.new_zeros((rows,) + contrib.shape[1:])
    return out[:num]


def segment_sums(blocks: Sequence[Tuple[torch.Tensor, SegmentMap, int]]
                 ) -> List[torch.Tensor]:
    """[out_i] for up to three blocks (contrib_i, map_i, num_i), out_i as
    segment_sum(contrib_i, map_i, num_i) would give it, in one launch of
    csrc/segment_sum.cu on CUDA tensors (every contrib on one device, one
    dtype, the maps built on it) or raising; on CPU tensors
    segment_sum_plain per block."""
    if not 1 <= len(blocks) <= MAX_BLOCKS:
        raise ValueError(f"segment_sums: 1 to {MAX_BLOCKS} blocks, got "
                         f"{len(blocks)}")
    first = blocks[0][0]
    if not first.is_cuda:
        for c, m, num in blocks:
            if c.device.type != "cpu":
                raise ValueError(f"segment_sum: unsupported device "
                                 f"{c.device}")
        return [segment_sum_plain(c, m, num) for c, m, num in blocks]
    dtype, device = first.dtype, first.device
    desc, outs, srcs, begin = [], [], [], 0
    for c, m, num in blocks:
        _check(c, m, num)
        if c.dtype != dtype or c.device != device:
            raise ValueError(f"segment_sums: blocks on {c.device} {c.dtype} "
                             f"and {device} {dtype}")
        if m.perm.device != device:
            raise ValueError("segment_sum: the map is not on the card "
                             "(build_map(..., device))")
        src = c if c.is_contiguous() else c.contiguous()
        srcs.append(src)  # alive until the launch has read its pointer
        w = math.prod(c.shape[1:])
        out = torch.empty((num,) + c.shape[1:], dtype=dtype, device=device)
        outs.append(out)
        desc += (src.data_ptr(), m.perm.data_ptr(), m.ptr.data_ptr(),
                 out.data_ptr(), begin, num, m.nseg, w, *m.bounds)
        begin += num * w
    if begin == 0:
        return outs
    # an absent block: no pointers, begins at the total, so no thread
    desc += (0, 0, 0, 0, begin, 0, 0, 1, 0, 0) * (MAX_BLOCKS - len(blocks))
    launch = _LAUNCH(*desc, begin)  # alive until the call has read it
    fn = kernels.entry("segment_sum", dtype)
    if device.index == torch.cuda.current_device():
        err = fn(ctypes.addressof(launch), kernels.stream(first))
    else:
        with torch.cuda.device(device):
            err = fn(ctypes.addressof(launch), kernels.stream(first))
    kernels.check_launch("segment_sum", err)
    kernels.count_launch(segment_sum)
    return outs


@kernels.counted
def segment_sum(contrib: torch.Tensor, m: SegmentMap,
                num: int) -> torch.Tensor:
    """out[row] = the sum of contrib[k] over the k that m maps to row, for
    rows [0, num); contrib is [K, ...] in f32 or f64.  A CUDA contrib
    launches csrc/segment_sum.cu (the map built on its device) or raises; a
    CPU contrib runs segment_sum_plain.  segment_sums with one block."""
    return segment_sums(((contrib, m, num),))[0]
