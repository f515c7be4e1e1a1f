"""One run of one cell: generate the seed's input, set the program up,
measure a window of whole solves, then judge what the window produced
against the plain reference (``port_bench/reference``).

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is read from its own file, found by the names in
``BENCHMARK.json``:

    port_bench/configs/<config>.json    the generator and its parameters
    port_bench/traffic/<mix>.json       which entry of the port the window
                                        drives (its "entry"), with that
                                        entry's parameters
    port_bench/limits/<cell>.json       the limits of the comparison
    port_bench/metrics/<metric>.py      read(reading) of a per-layer metric

    port_bench/entries/<entry>.py       class Entry: the entry a mix names;
                                        it sets the port up, solves once,
                                        gives its cell's end-to-end metrics
                                        by name and judges the answers

``setup_s`` is the harness's own, in every cell.  ``run_cell`` takes the
device as an argument so that the tests can drive a run on the CPU; the
command line (run.py) refuses to run without a card.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import random
import sys
import time
from typing import List

import numpy as np
import torch

from port_bench import trace as tr
from port_bench.reference import generators
from port_bench.reference.rtr import Budget

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
JAX_NAMES = ("jax", "jaxlib", "flax", "dcora_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(workload: str, root: str = ROOT) -> Cell:
    man = load_json(os.path.join(root, "BENCHMARK.json"))
    w = next((w for w in man["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"unknown workload {workload!r}")
    c = next(c for c in man["configs"] if c["name"] == w["config"])
    lim = os.path.join(root, "port_bench", "limits", f"{workload}.json")
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if workload in m.get("workloads", ()) or (
                 "workloads" not in m and m["moves"] in reported)]
    return Cell(workload=workload, chips=w["chips"],
                config=load_json(os.path.join(root, c["file"])),
                traffic=load_json(os.path.join(
                    root, "port_bench", "traffic", f"{w['traffic']}.json")),
                limits=load_json(lim)["limits"] if os.path.exists(lim)
                else {},
                end_to_end=e2e, per_layer=layer)


def instance_seeds(traffic: dict, seed: int) -> List[int]:
    """The seeds of the run's problem instances: the mix's own
    "instance_seeds" where it fixes them (the same work for every run,
    the run's seed choosing only the order), else "instances" of them
    drawn from the run's seed."""
    if "instance_seeds" in traffic:
        return list(traffic["instance_seeds"])
    return [seed % 2**63] + [
        int(np.random.SeedSequence([seed % 2**63, i]).generate_state(
            1, np.uint64)[0] % 2**63)
        for i in range(1, traffic.get("instances", 1))]


def make_input(config: dict, inst_seed: int, directory: str,
               i: int = 0) -> str:
    """Problem instance i, drawn by inst_seed.  A configuration with a
    "structure_seed" is one fixed graph (drawn by that seed) whose
    measurements inst_seed draws anew (renoise_g2o)."""
    gen = config["generator"]
    ext = {"grid_g2o": ".g2o", "ra_slam_pyfg": ".pyfg"}[gen]
    path = os.path.join(directory, f"{config['name']}.{i}{ext}")
    fixed = config.get("structure_seed")
    params = config["params"]
    generators.GENERATORS[gen](path, seed=inst_seed if fixed is None
                               else fixed, **params)
    if fixed is not None:
        generators.renoise_g2o(path, params["rot_noise"],
                               params["trans_noise"], inst_seed)
    return path


def budget(traffic: dict) -> Budget:
    """The reference solve's budget: the mix's own."""
    return Budget(max_outer=traffic["max_outer"],
                  max_inner=traffic["max_inner"],
                  gradnorm_tol=traffic["gradnorm_tol"],
                  initial_radius=traffic["initial_radius"])


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _load(folder: str, name: str):
    """The module port_bench/<folder>/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{folder}_" + name.replace(".", "_"),
        os.path.join(BENCH, folder, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(name: str):
    """The class Entry of port_bench/entries/<name>.py: the entry of the
    port a mix's window drives, named by the mix's "entry"."""
    return _load("entries", name).Entry


def load_metric(name: str):
    """read(reading) of port_bench/metrics/<name>.py."""
    return _load("metrics", name).read


def jax_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(JAX_NAMES))


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------


def _log(s: str):
    print(s, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, tmpdir: str, t_process: float, log=_log,
             warmup: bool = True) -> dict:
    """One run of `cell` on `device`: set-up from the process's start
    `t_process` (perf_counter), the window, the comparison.  Returns the
    result line's object, its "checks" last.  warmup=False leaves out the
    warm-up solve (calibrate.py, which reads the comparison alone)."""
    device = torch.device(device)
    tap = None
    if trace:
        tap = tr.LaunchTap()
        tap.install()
    t0 = time.perf_counter()
    seeds = instance_seeds(cell.traffic, seed)
    k = len(seeds)
    paths = [make_input(cell.config, s, tmpdir, i)
             for i, s in enumerate(seeds)]
    t1 = time.perf_counter()
    mix = load_entry(cell.traffic["entry"])(cell.traffic, paths, seeds,
                                            device)
    t2 = time.perf_counter()
    # the instances in an order drawn from the seed
    first = random.Random(seed).randrange(k)
    order = [(first + j) % k for j in range(k)]
    if warmup:
        mix.solve(order[0])  # builds the kernels, captures the graphs
    sync(device)
    t3 = time.perf_counter()
    setup_s = t3 - t_process
    log(f"set-up {setup_s:.3f} s: start {t0 - t_process:.3f}, generate "
        f"{t1 - t0:.3f}, program and start {t2 - t1:.3f}, warm-up solve "
        f"{t3 - t2:.3f}")

    # the window: whole solves until `seconds` have passed; the answers
    # of a sample drawn by the seed are kept for the comparison
    rng = random.Random(seed)
    answers: List[dict] = []
    sampled: List[dict] = []
    raised = 0
    prof = tr.Profile() if trace else None
    traced_s, modes = None, None
    stages: List[dict] = []  # of the solves after the traced ones
    modes0 = tap.snapshot() if tap else None
    if prof:
        prof.__enter__()  # the profiler's start-up (~10 s) stays outside
    t_open = time.perf_counter()
    while True:
        try:
            ans = mix.solve(order[len(answers) % k])
            sync(device)
        except Exception as e:  # noqa: BLE001  (a solve that raises fails)
            log(f"solve {len(answers)} raised {type(e).__name__}: {e}")
            raised = 1
            break
        answers.append(ans)
        if len(sampled) < mix.samples:
            sampled.append(ans)
        else:
            j = rng.randrange(len(answers))
            if j < mix.samples:
                sampled[j]["X"] = None
                sampled[j] = ans
            else:
                ans["X"] = None
        now = time.perf_counter() - t_open
        if prof and traced_s is None:
            if now >= tr.TRACE_SECONDS:
                prof.__exit__(None, None, None)
                traced_s, modes = now, tap.snapshot() - modes0
        elif prof:
            stages.append(ans["stages"])
        if now >= seconds and (stages or not prof):
            break
    elapsed = time.perf_counter() - t_open
    if prof and traced_s is None:
        prof.__exit__(None, None, None)
        traced_s, modes = elapsed, tap.snapshot() - modes0

    found = jax_modules()
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}: the "
                         "benchmark measures the PyTorch port alone")
    cuda = device.type == "cuda"
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1 if cuda else 0,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                if cuda else 0}
    out = {"correct": False, "attempted": len(answers) + raised,
           "failed": raised + sum(1 for a in answers if not mix.ok(a)),
           "metrics": {}, "device": dev_info}
    e2e = {"setup_s": setup_s,
           **(mix.end_to_end(elapsed, answers) if answers else {})}
    if trace:
        from port_bench import roofline

        reading = tr.Reading(
            prof.reduce(), traced_s, modes, stages,
            getattr(mix, "graph", None), getattr(mix, "r", None), mix.dtype,
            roofline.peaks(dev_info["kind"]), cell.traffic["entry"])
        del prof
        for m in cell.per_layer:
            v = load_metric(m["name"])(reading)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = reading.reduced.busy_s
        dev_info["window_s"] = reading.window_s
        out["breakdown"] = {"device_ops": reading.reduced.top_ops(),
                            "idle_gaps": reading.reduced.idle_gaps()}
    else:
        for m in cell.end_to_end:
            v = e2e.get(m["name"])
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}

    # the comparison, once the program's state is freed
    for a in sampled:
        mix.keep(a)
    mix.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = mix.check(answers, sampled, device, log) if sampled else {}
    log(f"comparison {time.perf_counter() - t_check:.3f} s over "
        f"{len(answers)} answers, {len(sampled)} sampled")
    # the numbers the cell's limits name are compared; with no limits
    # yet (calibration) every number is reported against none
    ok = bool(answers) and out["failed"] == 0 and bool(cell.limits)
    checks = {}
    for name, v in numbers.items():
        lim = cell.limits.get(name)
        if lim is None and cell.limits:
            continue
        checks[name] = {"value": v,
                        "limit": None if lim is None else lim["limit"]}
        ok = ok and lim is not None and v <= lim["limit"]
    ok = ok and set(cell.limits) <= set(checks)
    out["correct"] = ok
    out["readings"] = numbers
    out["checks"] = checks
    return out
