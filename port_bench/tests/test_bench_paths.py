"""A run writes only inside its checkout, HOME, XDG_CACHE_HOME and TMPDIR,
and its generated files are a few MB."""

import json
import os
import subprocess
import sys

import pytest

from port_bench.tests.conftest import ROOT


def _listing(d):
    try:
        return set(os.listdir(d))
    except OSError:
        return set()


def test_a_run_writes_only_where_it_may(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        (tmp_path / k).mkdir()
        env[k] = str(tmp_path / k)
    shm0, tmp0 = _listing("/dev/shm"), _listing("/tmp")
    code = ("import sys, time, tempfile, shutil\n"
            "from port_bench.tests.conftest import run_small\n"
            "out = run_small('grid3d.tiles', seconds=0.2)\n"
            "print(out['attempted'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert _listing("/dev/shm") - shm0 == set()
    new_tmp = _listing("/tmp") - tmp0
    assert not [p for p in new_tmp if not p.startswith("pytest-")], new_tmp
    # what the run left in TMPDIR is gone (the generated set lived there)
    assert os.listdir(tmp_path / "TMPDIR") == []


CONFIGS = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["configs"]


@pytest.mark.parametrize("config", [c["file"] for c in CONFIGS])
def test_generated_sets_are_a_few_mb(tmp_path, config):
    from port_bench import harness

    cfg = json.load(open(os.path.join(ROOT, config)))
    path = harness.make_input(cfg, 2**31 + 7, str(tmp_path))
    assert os.path.getsize(path) < 10 * 2**20
