"""Where the time of one certified solve goes, on one CUDA device.

    python -m dcora_tpu_torch.tools.profile_slice [--target-poses 10000]
        [--out profile.json]
    python -m dcora_tpu_torch.tools.profile_slice file.pyfg

Without an input file, generates the ``generate_large_scale_g2o`` grid and
profiles ``drivers.single_robot_pgo.run(..., certify=True,
device="cuda")``: once to warm up (kernel build, library handles), once on
the host clock alone, and once under ``torch.profiler`` with CUDA
activity.  With a ``.g2o`` file it profiles that file the same way.
Reports the wall time of each stage, the device's busy and idle share of
the unprofiled wall (device busy = the union of kernel intervals in the
profiled run), the kernel time by name, and the SpMM kernels' launches and
share.

With a ``.pyfg`` file (``tools.common.ra_set`` writes the generated RA
sets; 1950 poses per robot is the 9,750-pose ``ra10k`` set), it runs
``drivers.single_robot_raslam.run(..., device="cuda")`` once, after
building the kernels (one RA solve at that size takes minutes to hours):
every RTR call of the staircase is logged (backend, tile dtype, rank,
outer iterations, tCG steps, seconds), and the first call of each kind
(f32 tiles, f64 tiles, f64 edge path) runs under ``torch.profiler``, which
gives that kind's device busy / idle share and its kernel time by name.
It also reports the BTD applications per (r_pad, dtype) (the kernel's own
launch count beside them), the CUDA-event ms of one application through
its kernel (``tiled.btd_solve``, ``csrc/btd_solve.cu``) and through the
plain loop at the solve's shapes, the bound, and the share of the wall
that the kernel's applications take.

The SpMM layout is the build's default: set ``DCORA_SPMM_PACK=paired`` to
profile the paired packs.  Prints one JSON object and writes it to
``--out`` when given.  Refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from dcora_tpu_torch import datasets, solvers, staircase
from dcora_tpu_torch.core import rtr as rtr_mod
from dcora_tpu_torch.core import spmm, tiled
from dcora_tpu_torch.tools import common


class CallLog:
    """Wraps the staircase's RTR calls (solvers.rtr, staircase.rtr) and the
    tCG solver: one record per RTR call (its cost and gradnorm at the end
    included), and, when `profile` is set, a torch.profiler summary of the
    first call of each kind (CUDA only).  Profiling slows every later
    kernel launch of the process, so a caller that times the whole solve
    turns it off.  Without profiling it also logs a solve on the CPU."""

    def __init__(self, profile: bool = True):
        self.profile = profile
        self.calls, self.profiles = [], {}
        self._inner = 0
        self.overhead_s = 0.0  # the profiler's own time inside the solve

    def __enter__(self):
        real_rtr, real_tcg = rtr_mod.rtr, rtr_mod.truncated_cg

        def tcg(*args, **kw):
            res = real_tcg(*args, **kw)
            self._inner += int(res.inner_iters)
            return res

        def logged(P, G, M, X0, cfg, be=rtr_mod.RA_BACKEND, radius0=None):
            flat = be is rtr_mod.FLAT_BACKEND
            kind = (f"{'tiles' if flat else 'edge'} "
                    f"{str(P.dtype if flat else torch.float64)[6:]}")
            lead = X0 if flat else X0.rot
            sync = (torch.cuda.synchronize if lead.is_cuda
                    else (lambda: None))
            sync()
            self._inner, t0 = 0, time.perf_counter()
            if self.profile and kind not in self.profiles:
                acts = [torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    res = real_rtr(P, G, M, X0, cfg, be=be, radius0=radius0)
                    sync()
                    wall = time.perf_counter() - t0
                ks = _kernel_summary(prof)
                self.overhead_s += time.perf_counter() - t0 - wall
                self.profiles[kind] = dict(
                    wall_s=wall, **ks,
                    device_busy_share=ks["kernel_busy_s"] / wall,
                    device_idle_share=1.0 - ks["kernel_busy_s"] / wall)
            else:
                res = real_rtr(P, G, M, X0, cfg, be=be, radius0=radius0)
                sync()
                wall = time.perf_counter() - t0
            self.calls.append(dict(
                kind=kind, rank=None if flat else X0.r,
                r_pad=X0.shape[0] if flat else None,
                outers=res.outer_iters, tcg_steps=self._inner,
                f=float(res.f_final),
                gradnorm=float(res.gradnorm_final), seconds=wall,
                ms_per_tcg_step=wall * 1e3 / max(self._inner, 1)))
            return res

        self._restore = [(rtr_mod, "truncated_cg", real_tcg),
                         (solvers, "rtr", solvers.rtr),
                         (staircase, "rtr", staircase.rtr)]
        rtr_mod.truncated_cg = tcg
        solvers.rtr = staircase.rtr = logged
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)

    def by_kind(self) -> dict:
        out = defaultdict(lambda: dict(calls=0, seconds=0.0, tcg_steps=0))
        for c in self.calls:
            k = out[c["kind"]]
            k["calls"] += 1
            k["seconds"] += c["seconds"]
            k["tcg_steps"] += c["tcg_steps"]
        for k in out.values():
            k["ms_per_tcg_step"] = k["seconds"] * 1e3 / max(k["tcg_steps"], 1)
        return dict(out)


def _solve(path: str) -> dict:
    """One certified solve of a .g2o or .pyfg file on the card, with its
    stages, SpMM launches and BTD applications."""
    tps = {}

    def key(TP, Vf):
        if TP.btd_ltil is None:
            return None
        k = (Vf.shape[0], str(Vf.dtype).split(".")[-1])
        tps[k] = TP
        return k

    res = {}
    spmm.reset_launches()
    # applications recorded in a tCG graph count once per replay
    counts, restore = common.count_calls(tiled, "precondition_flat", key)
    try:
        t0 = time.perf_counter()
        if path.endswith(".pyfg"):
            from dcora_tpu_torch.drivers.single_robot_raslam import run

            run(path, device="cuda", verbose=False, result=res)
            f = res["f_rounded"]
        else:
            from dcora_tpu_torch.drivers.single_robot_pgo import run

            _, f = run(path, certify=True, device="cuda", verbose=False,
                       result=res)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    counts.pop(None, None)
    st = res["staircase"]
    return dict(wall_s=wall, f=f, f_lifted=st.f_final, rank=st.final_rank,
                certified=st.certified, gradnorm=st.gradnorm_final,
                init_s=res["init_s"], read_s=res.get("read_s"),
                stages_s=dict(st.stage_seconds),
                spmm_launches=sum(v for k, v in spmm.launch_counts().items()
                                  if k.startswith("spmm_")),
                launches=spmm.launch_counts(),
                btd_applications={f"{r}/{dt}": c
                                  for (r, dt), c in counts.items()},
                _btd_tps=tps)


def btd_times(tps: dict, counts: dict, wall_s: float) -> list:
    """Per (r_pad, dtype) of a solve: CUDA-event ms of one BTD application
    through its kernel and through the plain loop (median of 3 turns, on
    the solve's own TiledProblem), the bound, and the kernel's share of
    the solve's wall."""
    gbs = common.nominal_hbm_gbs(torch.cuda.get_device_name(0)) or \
        common.NOMINAL_HBM_GBS[0][1]
    rows = []
    for (r_pad, dt), TP in sorted(tps.items()):
        dtype = getattr(torch, dt)
        gen = torch.Generator(device="cuda").manual_seed(r_pad)
        V = torch.randn((r_pad, TP.meta.kpad), generator=gen, dtype=dtype,
                        device="cuda")
        kernel_ms, plain_ms = common.time_turns_ms(
            [lambda: tiled.btd_solve(TP, V),
             lambda: tiled._precondition_btd(TP, V)], n=10)
        bound, by = common.btd_bound_ms(TP.meta.nt, TP.meta.T, r_pad, dtype,
                                        gbs)
        n = counts[f"{r_pad}/{dt}"]
        rows.append(dict(r_pad=r_pad, dtype=dt, nt=TP.meta.nt,
                         applications=n, kernel_ms=kernel_ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         kernel_share_of_wall=n * kernel_ms * 1e-3 / wall_s))
    return rows


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
    ap.add_argument("input", nargs="?", default="",
                    help=".g2o or .pyfg file (default: the generated grid)")
    ap.add_argument("--target-poses", type=int, default=10_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    common.require_cuda("profile_slice")
    smi = common.card()
    with tempfile.TemporaryDirectory() as tmp:
        if args.input:
            path = args.input
        else:
            path = datasets.generate_large_scale_g2o(
                os.path.join(tmp, "grid.g2o"),
                target_poses=args.target_poses)
        out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                   torch=torch.__version__, input=os.path.basename(path),
                   spmm_pack=os.environ.get("DCORA_SPMM_PACK", "bucketed"))
        if path.endswith(".pyfg"):
            spmm.build_all()
            with CallLog() as log:
                solve = _solve(path)
            out.update(solve=solve, by_kind=log.by_kind(),
                       profiles=log.profiles, calls=log.calls,
                       profiler_overhead_s=log.overhead_s)
        else:
            _solve(path)  # warm-up
            solve = plain = _solve(path)
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                profiled = _solve(path)
            profiled.pop("_btd_tps")
            ks = _kernel_summary(prof)
            busy = ks["kernel_busy_s"]
            out.update(unprofiled=plain, profiled=profiled, **ks,
                       device_busy_share=busy / plain["wall_s"],
                       device_idle_share=1.0 - busy / plain["wall_s"],
                       spmm_share_of_busy=ks["spmm_seconds"] / max(busy,
                                                                   1e-12),
                       host_s_per_spmm_launch=(
                           plain["stages_s"].get("solve", 0.0)
                           / max(plain["spmm_launches"], 1)))
        out["btd"] = btd_times(solve.pop("_btd_tps"),
                               solve["btd_applications"], solve["wall_s"])
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
