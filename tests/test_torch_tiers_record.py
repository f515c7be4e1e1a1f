"""tools/tiers_partial_record.py of the PyTorch port: the in-progress row
of an RA-SLAM staircase from its NPZ checkpoint, here one that the port's
staircase wrote on a generated PyFG set (and one the JAX package's wrote),
independently verified and marked certified false / in progress, with the
checkpoint copied beside the record."""

import json
import os

import numpy as np
import pytest
import torch

import dcora_tpu.datasets as jds
import dcora_tpu.drivers.single_robot_raslam as jdriver
from dcora_tpu_torch import verification as tver
from dcora_tpu_torch.drivers.single_robot_raslam import run
from dcora_tpu_torch.io import read_pyfg_file
from dcora_tpu_torch.io.remap import get_global_measurements
from dcora_tpu_torch.tools import tiers_partial_record as tool
from dcora_tpu_torch.utils.checkpoint import load_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's solver loops issue tiny ops, which a thread pool beside
    the other test workers slows down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pyfg(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiers")
    return jds.generate_ra_slam_pyfg(str(d / "ra.pyfg"), num_robots=2,
                                     poses_per_robot=10, rot_noise=0.01,
                                     trans_noise=0.01, range_noise=0.01)


def test_record_from_the_ports_checkpoint(pyfg, tmp_path):
    ckpt = str(tmp_path / "ckpt.npz")
    st, _, gm = run(pyfg, device="cpu", verbose=False, checkpoint_path=ckpt)
    rec = tool.main([ckpt, "--pyfg", pyfg, "--out-dir", str(tmp_path),
                     "--name", "ra", "--device", "cpu"])
    assert rec["certified"] is False and rec["in_progress"] is True
    assert rec["final_rank"] == rec["checkpoint_rank"] == st.final_rank
    assert rec["platform"] == "cpu"
    np.testing.assert_allclose(rec["f_final"], st.f_final, rtol=1e-12)
    X, _, _, _ = load_checkpoint(ckpt)
    rep = tver.verify_solution(gm.relative_measurements, X, 3, eta=1e-4)
    for key in ("f_indep", "gradnorm_indep", "certified_indep",
                "psd_proof_indep", "manifold_err"):
        assert rec[key] == rep[key], key
    assert abs(rec["gradnorm_final"] - rep["gradnorm_indep"]) <= \
        1e-8 * max(1.0, rep["gradnorm_indep"])
    with open(tmp_path / "parity" / "ra.json") as fh:
        assert json.load(fh)["f_final"] == rec["f_final"]
    assert os.path.exists(tmp_path / "ra_checkpoint.npz")


def test_record_from_a_jax_checkpoint(pyfg, tmp_path):
    """The JAX staircase's checkpoint (as artifacts/tiers_checkpoint_r5.npz
    is one) gives the row of the same state."""
    ckpt = str(tmp_path / "jax.npz")
    res, _, _ = jdriver.run(pyfg, verbose=False, checkpoint_path=ckpt)
    rec = tool.record(pyfg, ckpt, device="cpu")
    assert rec["final_rank"] == int(res.final_rank)
    np.testing.assert_allclose(rec["f_final"], float(res.f_final),
                               rtol=1e-10, atol=1e-12)
    ds = read_pyfg_file(pyfg)
    assert rec["manifold_err"] < 1e-10
    assert len(get_global_measurements(ds).relative_measurements) > 0


def test_missing_pyfg_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tool.main([str(tmp_path / "none.npz"), "--pyfg",
                   str(tmp_path / "tiers.pyfg")])
