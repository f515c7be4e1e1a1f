"""run.py refuses to measure without a card, and fails without the port."""

import json
import os
import shutil
import subprocess
import sys

from port_bench.tests.conftest import ROOT


def _no_result(stdout):
    for line in stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result was printed: {line}")


def test_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "grid3d.tiles",
         "--seed", "2147483660", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "CUDA device" in out.stderr
    _no_result(out.stdout)


def test_fails_with_the_benchmark_alone(tmp_path):
    """A directory with BENCHMARK.json and port_bench only: the port is
    missing, so the run fails before any result (driven past the card
    check, on the CPU)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from port_bench import harness\n"
            "cell = harness.find_cell('grid3d.tiles', '.')\n"
            "print(harness.run_cell(cell, 5, 1.0, False, 'cpu', '.', "
            "time.perf_counter()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert "dcora_tpu_torch" in out.stderr
    _no_result(out.stdout)
