"""Nothing under port_bench loads JAX or the JAX package, and the plain
reference loads nothing of the port.  Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from port_bench.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "port_bench")
JAX = {"jax", "jaxlib", "flax", "dcora_tpu"}


def _py_files(directory):
    for base, _, files in os.walk(directory):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    for path in _py_files(BENCH):
        assert not set(_imports(path)) & JAX, path


def test_reference_sources_import_nothing_of_the_port():
    for path in _py_files(os.path.join(BENCH, "reference")):
        assert "dcora_tpu_torch" not in set(_imports(path)), path


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_importing_the_harness_loads_no_jax():
    names = _loaded(
        "import sys, glob, os\n"
        "import port_bench.run, port_bench.harness, port_bench.control\n"
        "import port_bench.roofline, port_bench.trace\n"
        "from port_bench import harness\n"
        "import dcora_tpu_torch.drivers.single_robot_pgo\n"
        "for f in glob.glob('port_bench/metrics/*.py'):\n"
        "    harness.load_metric(os.path.basename(f)[:-3])\n"
        "for f in glob.glob('port_bench/entries/*.py'):\n"
        "    harness.load_entry(os.path.basename(f)[:-3])\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    assert "port_bench" in names and not names & JAX


def test_the_reference_loads_nothing_of_the_port():
    names = _loaded(
        "import sys\n"
        "from port_bench.reference import generators, graph, problem, "
        "rtr, start\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    assert "port_bench" in names
    assert not names & (JAX | {"dcora_tpu_torch"})
