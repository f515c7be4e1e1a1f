"""Host layer of the PyTorch port vs the JAX package: generators, the g2o
parser, the independent verifier, and the no-JAX import rule."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dcora_tpu.datasets as jds
import dcora_tpu.io as jio
import dcora_tpu.native as jnative
import dcora_tpu.verification as jver
import dcora_tpu_torch.datasets as tds
import dcora_tpu_torch.io as tio
import dcora_tpu_torch.verification as tver
from dcora_tpu_torch.utils.logger import Logger
from torch_port_common import jax_state, random_state_arrays, torch_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GENERATED = {
    "tinyGrid3D": ("generate_grid_g2o", jds._TEST_SETS["tinyGrid3D.g2o"]),
    "smallGrid3D": ("generate_grid_g2o", jds._TEST_SETS["smallGrid3D.g2o"]),
    "noiseless": ("generate_noiseless_pgo_g2o", {}),
    "large216": ("generate_large_scale_g2o", dict(target_poses=216)),
    "ra_pyfg": ("generate_ra_slam_pyfg", {}),
}


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generators_write_identical_files(tmp_path, name):
    fn, kw = GENERATED[name]
    a = getattr(jds, fn)(str(tmp_path / "jax.txt"), **kw)
    b = getattr(tds, fn)(str(tmp_path / "torch.txt"), **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _g2o_arrays(ds):
    ms = ds.pose_pose_measurements
    gt = sorted(ds.ground_truth_poses.items(), key=lambda kv: kv[0].frame_id)
    return dict(
        ij=np.array([(m.p1, m.p2) for m in ms]),
        R=np.stack([m.R for m in ms]), t=np.stack([m.t for m in ms]),
        kappa=np.array([m.kappa for m in ms]),
        tau=np.array([m.tau for m in ms]),
        fixed=np.array([m.fixedWeight for m in ms]),
        gt=np.stack([T for _, T in gt]) if gt else np.zeros(0),
        meta=np.array([ds.dim, ds.num_poses]),
    )


def _write_2d(path):
    """A 2-D g2o file (EDGE_SE2 records only), written by the JAX
    package's serializer."""
    from dcora_tpu.measurements import RelativePosePoseMeasurement

    rng = np.random.default_rng(4)
    ms = []
    for i in range(20):
        th = rng.uniform(-np.pi, np.pi)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        ms.append(RelativePosePoseMeasurement(
            0, i, 0, i + 1 + (i % 3 == 0), R, rng.standard_normal(2),
            kappa=rng.uniform(1, 9), tau=rng.uniform(1, 9)))
    return jds.write_g2o(path, ms, 2)


@pytest.mark.parametrize("name", ["tinyGrid3D", "smallGrid3D", "plane2d"])
@pytest.mark.parametrize("native", [False, True])
def test_g2o_parser_identical_arrays(tmp_path, monkeypatch, name, native):
    """The port's numpy path (its native library switched off) against the
    JAX package's numpy path: identical arrays; the port's default reader
    (its own build of the native library) against the JAX package's native
    (ctypes) parser: to the last few ulps (test_torch_native.py holds them
    identical)."""
    path = str(tmp_path / "f.g2o")
    if name == "plane2d":
        _write_2d(path)
    else:
        fn, kw = GENERATED[name]
        getattr(jds, fn)(path, **kw)
    if not native:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setenv("DCORA_NATIVE", "0")
    elif not jnative.available():
        pytest.skip("native parser library not available")
    ref = _g2o_arrays(jio.read_g2o_file(path))
    out = _g2o_arrays(tio.read_g2o_file(path))
    for key in ref:
        if native:
            np.testing.assert_allclose(out[key], ref[key], rtol=1e-14,
                                       atol=1e-14, err_msg=key)
        else:
            np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


def test_verifier_matches_reference(tmp_path):
    """The port's scipy verifier reports what the JAX package's does."""
    path = str(tmp_path / "t.g2o")
    jds.generate_grid_g2o(path, **jds._TEST_SETS["tinyGrid3D.g2o"])
    ms_j = jio.read_g2o_file(path).pose_pose_measurements
    ms_t = tio.read_g2o_file(path).pose_pose_measurements
    from dcora_tpu.types import ProblemDims

    arrs = random_state_arrays(np.random.default_rng(0), ProblemDims(3, 8), 5)
    rj = jver.verify_solution(ms_j, jax_state(arrs), 3, eta=1e-3)
    rt = tver.verify_solution(ms_t, torch_state(arrs), 3, eta=1e-3)
    assert rt["certified_indep"] == rj["certified_indep"]
    assert rt["psd_proof_indep"] == rj["psd_proof_indep"]
    for key in ("f_indep", "gradnorm_indep", "manifold_err", "min_eig_indep"):
        np.testing.assert_allclose(rt[key], rj[key], rtol=1e-10, atol=1e-12,
                                   err_msg=key)


def test_logger_trajectory_identical(tmp_path):
    from dcora_tpu.utils.logger import Logger as JLogger

    rng = np.random.default_rng(1)
    T = np.zeros((5, 3, 4))
    for i in range(5):
        T[i, :, :3] = jds._rand_rotation(rng, np.pi)
        T[i, :, 3] = rng.standard_normal(3)
    JLogger(str(tmp_path / "j")).log_trajectory(3, 5, T, "a.txt")
    Logger(str(tmp_path / "t")).log_trajectory(3, 5, T, "a.txt")
    assert (tmp_path / "j" / "a.txt").read_bytes() == \
        (tmp_path / "t" / "a.txt").read_bytes()


def test_import_pulls_in_no_jax():
    """Every module of the port imports without JAX (fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dcora_tpu_torch\n"
        "for m in pkgutil.walk_packages(dcora_tpu_torch.__path__,"
        " 'dcora_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'dcora_tpu'"
        " or m.startswith('dcora_tpu.')]\n"
        "print(len(list(pkgutil.walk_packages(dcora_tpu_torch.__path__))))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 10


def test_numerics_policy():
    import dcora_tpu_torch

    assert dcora_tpu_torch.DTYPE == torch.float64
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_profile_kernel_summary_unions_intervals():
    """The profile tool's device-busy time is the union of kernel intervals
    (overlaps counted once); host events are ignored."""
    from types import SimpleNamespace as NS

    from dcora_tpu_torch.tools.profile_slice import _kernel_summary

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def evt(name, start, end, dev=cuda):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=start, end=end))

    events = [evt("spmm_sym_kernel<float, 8>", 0, 100),
              evt("add", 50, 150), evt("add", 300, 310),
              evt("aten::add", 0, 1000, dev=cpu)]
    out = _kernel_summary(NS(events=lambda: events))
    assert out["kernels"] == 3
    assert out["kernel_busy_s"] == pytest.approx(160e-6)
    assert out["spmm_seconds"] == pytest.approx(100e-6)
    assert out["by_name"] == [
        dict(name="add", count=2, seconds=pytest.approx(110e-6)),
        dict(name="spmm_sym_kernel<float, 8>", count=1,
             seconds=pytest.approx(100e-6))]


def test_profile_tool_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "dcora_tpu_torch.tools.profile_slice"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py fails closed where CUDA is absent, and alone in an
    otherwise empty directory; it prints no result line either way."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = os.path.join(REPO, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(src, "rb").read())
    for script, cwd in ((src, REPO), (str(lone), str(tmp_path))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
