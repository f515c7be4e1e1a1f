"""A cell is added by new files and a manifest entry, with no edit to a
file that is there: a copy of the benchmark gains a traffic mix (data
only), a per-layer metric, limits and a cell, and runs it, untraced and
traced (on the CPU at a test's size, past the card check)."""

import json
import os
import shutil
import subprocess
import sys

from port_bench.tests.conftest import ROOT, SMALL

METRIC = '''"""Seconds of the traced window."""


def read(t):
    return t.window_s
'''

RUN = '''import json, sys, tempfile, time
sys.path.insert(0, ".")
from port_bench import harness
cell = harness.find_cell("grid3d.short", ".")
cell.config = dict(cell.config, params=dict(cell.config["params"],
                                            **SMALLPARAMS))
for trace in (False, True):
    with tempfile.TemporaryDirectory() as tmp:
        out = harness.run_cell(cell, 2**31 + 99, 0.3, trace, "cpu", tmp,
                               time.perf_counter(), log=lambda s: None)
    out.pop("readings")
    print(json.dumps(out))
'''


def test_a_cell_added_by_files_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "port_bench"
    mix = json.load(open(bench / "traffic" / "tiles.json"))
    json.dump(dict(mix, max_outer=3), open(bench / "traffic" / "short.json",
                                           "x"))
    shutil.copy(bench / "limits" / "grid3d.tiles.json",
                bench / "limits" / "grid3d.short.json")
    (bench / "metrics" / "traced_window_s.py").write_text(METRIC)
    man = json.load(open(tmp_path / "BENCHMARK.json"))
    man["workloads"].append({"name": "grid3d.short", "config": "grid3d",
                             "traffic": "short", "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] == "pose_iters_per_s":
            m["workloads"].append("grid3d.short")
    man["per_layer"].append({"name": "traced_window_s", "unit": "s",
                             "better": "lower", "source": "host_clock",
                             "layer": "test", "moves": "pose_iters_per_s",
                             "workloads": ["grid3d.short"]})
    json.dump(man, open(tmp_path / "BENCHMARK.json", "w"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    code = RUN.replace("SMALLPARAMS", repr(SMALL["grid3d"]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(line) for line in
                     out.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"], (plain, traced)
    assert set(plain["metrics"]) == {"pose_iters_per_s", "setup_s"}
    assert traced["metrics"]["traced_window_s"]["value"] > 0
    assert "breakdown" in traced and traced["device"]["window_s"] > 0
