"""Where the time of one certified solve goes, on one CUDA device.

    python -m dcora_tpu_torch.tools.profile_slice [--target-poses 10000]
        [--out profile.json]

Generates the ``generate_large_scale_g2o`` grid, runs
``drivers.single_robot_pgo.run(..., certify=True, device="cuda")`` once to
warm up (kernel build, library handles), once on the host clock alone, and
once under ``torch.profiler`` with CUDA activity.  Reports the wall time of
each stage, the device's busy and idle share of the unprofiled wall (device
busy = the union of kernel intervals in the profiled run), the kernel time
by name, and the SpMM kernels' launches and share.  The SpMM layout is the
build's default: set ``DCORA_SPMM_PACK=paired`` to profile the paired
buckets.  Prints one JSON object and writes it to ``--out`` when given.
Refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from dcora_tpu_torch import datasets
from dcora_tpu_torch.core import spmm
from dcora_tpu_torch.drivers.single_robot_pgo import run
from dcora_tpu_torch.tools import common


def _solve(path: str) -> dict:
    res = {}
    spmm.reset_launches()
    t0 = time.perf_counter()
    _, f = run(path, certify=True, device="cuda", verbose=False, result=res)
    torch.cuda.synchronize()
    st = res["staircase"]
    return dict(wall_s=time.perf_counter() - t0, f=f, rank=st.final_rank,
                certified=st.certified, init_s=res["init_s"],
                stages_s=dict(st.stage_seconds),
                spmm_launches=sum(spmm.launch_counts().values()),
                launches=spmm.launch_counts())


def _kernel_summary(prof) -> dict:
    """Busy time (union of kernel intervals) and time by kernel name."""
    spans, by_name = [], defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        by_name[evt.name][0] += 1
        by_name[evt.name][1] += (end - start) * 1e-6
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return dict(kernel_busy_s=busy * 1e-6, kernels=len(spans),
                by_name=[dict(name=k[:120], count=c, seconds=s)
                         for k, (c, s) in top[:20]],
                spmm_seconds=sum(s for k, (c, s) in by_name.items()
                                 if any(f"spmm_{n}_kernel" in k for n in
                                        ("sym", "tile", "grouped"))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target-poses", type=int, default=10_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    common.require_cuda("profile_slice")
    smi = common.card()
    with tempfile.TemporaryDirectory() as tmp:
        path = datasets.generate_large_scale_g2o(
            os.path.join(tmp, "grid.g2o"), target_poses=args.target_poses)
        _solve(path)  # warm-up
        plain = _solve(path)
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            profiled = _solve(path)
        ks = _kernel_summary(prof)
    busy = ks["kernel_busy_s"]
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               torch=torch.__version__, target_poses=args.target_poses,
               spmm_pack=os.environ.get("DCORA_SPMM_PACK", "bucketed"),
               unprofiled=plain, profiled=profiled, **ks,
               device_busy_share=busy / plain["wall_s"],
               device_idle_share=1.0 - busy / plain["wall_s"],
               spmm_share_of_busy=ks["spmm_seconds"] / max(busy, 1e-12),
               host_s_per_spmm_launch=(plain["stages_s"].get("solve", 0.0)
                                       / max(plain["spmm_launches"], 1)))
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
