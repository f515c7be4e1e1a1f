"""native.py, the PyTorch port's ctypes binding of native/ (the C ABI of
native/include/dcora_native.h), against the JAX package's dcora_tpu.native:
the port builds the library from the repository's sources into
dcora_tpu_torch/build/native/ (never through native/'s Makefile, whose
build/ holds committed objects), parses every generated file into the same
arrays, assembles the same block-Jacobi preconditioner, and gives way to
the numpy paths under DCORA_NATIVE=0 or when the build fails."""

import hashlib
import logging
import os

import numpy as np
import pytest
import torch

import dcora_tpu.datasets as jds
import dcora_tpu.native as jnative
import dcora_tpu.solvers as jsolvers
import dcora_tpu_torch.native as tnative
from dcora_tpu_torch import solvers as tsolvers
from dcora_tpu_torch.io import read_g2o_file, read_pyfg_file
from test_torch_pyfg import PLANAR
from torch_port_common import build_graphs, np_of, random_graph_spec


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's solver loops issue tiny ops, which a thread pool beside
    the other test workers slows down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.join(os.path.dirname(__file__), os.pardir)
NATIVE_BUILD = os.path.join(REPO, "native", "build")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every generated test file, a 2D g2o file and a planar PyFG file."""
    d = str(tmp_path_factory.mktemp("native"))
    jds.ensure_test_datasets(d)
    out = {f: os.path.join(d, f) for f in sorted(os.listdir(d))}
    out["ra_noisy.pyfg"] = jds.generate_ra_slam_pyfg(
        os.path.join(d, "ra_noisy.pyfg"), num_robots=3, poses_per_robot=10,
        rot_noise=0.01, trans_noise=0.01, range_noise=0.01, seed=4)
    out["planar.pyfg"] = os.path.join(d, "planar.pyfg")
    with open(out["planar.pyfg"], "w") as fh:
        fh.write(PLANAR)
    out["grid2d.g2o"] = jds.generate_grid_g2o(
        os.path.join(d, "grid2d.g2o"), shape=(4, 5, 1), seed=9)
    return out


def _digests(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _fresh(monkeypatch, build_dir):
    """The binding as in a new process, building into `build_dir`."""
    monkeypatch.setattr(tnative, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "build_error", None)
    monkeypatch.delenv("DCORA_NATIVE", raising=False)


def test_builds_from_the_sources_beside_native_build(tmp_path, monkeypatch):
    before = _digests(NATIVE_BUILD)
    _fresh(monkeypatch, tmp_path / "native")
    assert tnative.available()
    path = tnative.library_path()
    assert os.path.dirname(path) == str(tmp_path / "native")
    assert os.path.exists(path) and tnative.build_error is None
    assert _digests(NATIVE_BUILD) == before  # native/build/ untouched


def test_default_build_dir_is_the_ports():
    assert tnative.BUILD_DIR == os.path.join(
        os.path.dirname(tnative.__file__), "build", "native")
    assert tnative.library_path().startswith(tnative.BUILD_DIR)


def test_failing_build_logs_once_and_falls_back(tmp_path, monkeypatch,
                                                caplog, files):
    _fresh(monkeypatch, tmp_path / "native")
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    with caplog.at_level(logging.WARNING, logger=tnative.__name__):
        assert not tnative.available()
        assert not tnative.available()
        ds = read_g2o_file(files["tinyGrid3D.g2o"])
    assert ds.reader == "numpy"
    assert "false failed" in tnative.build_error
    assert sum("not built" in r.getMessage() for r in caplog.records) == 1


def _g2o_fields(a):
    return {k: getattr(a, k) for k in ("v_ids", "v_R", "v_t", "e_i", "e_j",
                                       "e_R", "e_t", "e_kappa", "e_tau")}


def _flat(a, prefix=""):
    out = {}
    for k, v in vars(a).items():
        if isinstance(v, dict):
            out.update(_flat(type("A", (), v)(), f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return {k: v for k, v in out.items() if not k.startswith("_")
            and not k.endswith("__")}


@pytest.mark.parametrize("name", ["tinyGrid3D.g2o", "smallGrid3D.g2o",
                                  "pose_graph_optimization_test_3d.g2o",
                                  "grid2d.g2o"])
def test_parse_g2o_identical_to_jax(files, name):
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built")
    a, b = tnative.parse_g2o(files[name]), jnative.parse_g2o(files[name])
    assert a.dim == b.dim
    for k, v in _g2o_fields(b).items():
        np.testing.assert_array_equal(getattr(a, k), v, err_msg=k)
    ds = read_g2o_file(files[name])
    assert ds.reader == "native" and ds.dim == b.dim
    assert len(ds.pose_pose_measurements) == len(b.e_i)


@pytest.mark.parametrize("name", ["range_aided_slam_test_3d.pyfg",
                                  "ra_noisy.pyfg", "planar.pyfg"])
def test_parse_pyfg_identical_to_jax(files, name):
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built")
    a, b = tnative.parse_pyfg(files[name]), jnative.parse_pyfg(files[name])
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k, v in fb.items():
        np.testing.assert_array_equal(fa[k], v, err_msg=k)
    ds = read_pyfg_file(files[name])
    assert ds.reader == "native" and ds.dim == b.dim
    assert len(ds.measurements.relative_measurements) == \
        len(b.pp["seq"]) + len(b.pl["seq"]) + len(b.rg["seq"])


def test_parse_errors_raise(tmp_path):
    bad = tmp_path / "bad.g2o"
    bad.write_text("NOT_A_RECORD 1 2 3\n")
    with pytest.raises(ValueError):
        tnative.parse_g2o(str(bad))


def _ra_graphs(path):
    """(JAX, port) global RA-SLAM graphs of a PyFG file at rank 3."""
    import dcora_tpu.core.graph as jgraph
    import dcora_tpu.io as jio
    import dcora_tpu.io.remap as jremap
    import dcora_tpu.types as jtypes
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.io.remap import get_global_measurements
    from dcora_tpu_torch.types import GraphType

    gj = jgraph.LocalGraph(0, 3, 3, jtypes.GraphType.RangeAidedSLAMGraph)
    gj.set_measurements(jremap.get_global_measurements(
        jio.read_pyfg_file(path)).relative_measurements)
    gt = LocalGraph(0, 3, 3, GraphType.RangeAidedSLAMGraph)
    gt.set_measurements(get_global_measurements(
        read_pyfg_file(path)).relative_measurements)
    return gj, gt


@pytest.mark.parametrize("case", ["pgo0", "pgo1", "ra"])
def test_jacobi_precond_equal_to_jax(files, case):
    """The same graph through both packages' make_preconditioner (the
    native assembly): a random pose graph with random weights and no prior,
    and the RA problem of the noisy generated PyFG set.  The inputs are
    bitwise the same."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built")
    if case == "ra":
        gj, gt = _ra_graphs(files["ra_noisy.pyfg"])
    else:
        rng = np.random.default_rng(int(case[-1]))
        gj, gt = build_graphs(random_graph_spec(rng, n=12, l=0, b=0), r=5,
                              prior=False)
    Mj = jsolvers.make_preconditioner(gj, gj.problem_data())
    Mt = tsolvers.make_preconditioner(gt, gt.problem_data(device="cpu"))
    assert tsolvers.precond_build() == "native"
    # the same C++ on the same inputs: bit for bit where the host has
    # AVX-512 (native.cxx_flags builds as the committed JAX library was
    # built), a few ulps elsewhere (-march=native vectorizes the 4x4
    # inverses otherwise)
    for a, b in zip(Mt, Mj):
        assert a.dtype == torch.float64
        b = np_of(b)
        np.testing.assert_allclose(np_of(a), b, rtol=0,
                                   atol=1e-14 * np.abs(b).max(initial=1.0))


def test_native_off_gives_the_numpy_paths(files, monkeypatch):
    monkeypatch.setenv("DCORA_NATIVE", "0")
    assert not tnative.available()
    assert tnative.parse_g2o(files["tinyGrid3D.g2o"]) is None
    assert read_g2o_file(files["tinyGrid3D.g2o"]).reader == "numpy"
    assert read_pyfg_file(
        files["range_aided_slam_test_3d.pyfg"]).reader == "numpy"
    assert tsolvers.precond_build() == "numpy"
    _, gt = _ra_graphs(files["ra_noisy.pyfg"])
    P = gt.problem_data(device="cpu")
    M_numpy = tsolvers.make_preconditioner(gt, P)
    monkeypatch.setenv("DCORA_NATIVE", "1")
    M_native = tsolvers.make_preconditioner(gt, P)
    for a, b in zip(M_numpy, M_native):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-12,
                                   atol=1e-12)
