"""Chordal initialization on the caller's device.

The port's chordal initialization runs where its caller runs, the card by
default, and never falls back: a call that names no device on a machine
without CUDA raises from resolve_device before any work.  On the CPU,
when asked, it equals the JAX package's result (1e-10, the two CG solves
differing only in summation order).  Reading the CG stopping rule every 32
iterations (CG_READ_EVERY) gives the same iterate as reading it every
iteration, because every update is masked by that rule.
"""

import os

import numpy as np
import pytest
import torch

import dcora_tpu_torch.core.init as tinit
from dcora_tpu_torch.io import read_g2o_file as tread


@pytest.fixture(scope="module")
def grid(data_dir):
    return os.path.join(data_dir, "smallGrid3D.g2o")


def test_chordal_on_cpu_matches_jax(grid):
    from dcora_tpu.core import init as jinit
    from dcora_tpu.io import read_g2o_file as jread

    ref = jinit.chordal_initialization(jread(grid).pose_pose_measurements)
    out = tinit.chordal_initialization(tread(grid).pose_pose_measurements,
                                       device="cpu")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("check_every", [1, 7, 32])
def test_cg_stopping_rule_read_sparsely_changes_nothing(grid, check_every,
                                                        monkeypatch):
    ms = tread(grid).pose_pose_measurements
    monkeypatch.setattr(tinit, "CG_READ_EVERY", 1)
    ref = tinit.chordal_initialization(ms, device="cpu")
    monkeypatch.setattr(tinit, "CG_READ_EVERY", check_every)
    out = tinit.chordal_initialization(ms, device="cpu")
    np.testing.assert_array_equal(out, ref)


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
def test_no_device_without_cuda_raises_before_any_work(grid, monkeypatch):
    ms = tread(grid).pose_pose_measurements

    def no_work(*a, **k):
        raise AssertionError("chordal init ran on the CPU")

    monkeypatch.setattr(tinit, "_chordal_rotations", no_work)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinit.chordal_initialization(ms)


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
@pytest.mark.parametrize("entry", ["solve_pgo", "solve_robust_pgo",
                                   "single_robot_gnc", "chordal_example",
                                   "multi_robot_pgo", "multi_robot_raslam"])
def test_entry_points_default_to_the_card(grid, entry, data_dir):
    """Every new entry point defaults to CUDA and raises without it."""
    from dcora_tpu_torch import solvers
    from dcora_tpu_torch.drivers import (chordal_initialization_example,
                                         multi_robot_pgo, multi_robot_raslam,
                                         single_robot_gnc)

    ms = tread(grid).pose_pose_measurements
    calls = {
        "solve_pgo": lambda: solvers.solve_pgo(ms),
        "solve_robust_pgo": lambda: solvers.solve_robust_pgo(ms),
        "single_robot_gnc": lambda: single_robot_gnc.run(grid,
                                                         verbose=False),
        "chordal_example": lambda: chordal_initialization_example.run(
            grid, verbose=False),
        "multi_robot_pgo": lambda: multi_robot_pgo.run(2, grid),
        "multi_robot_raslam": lambda: multi_robot_raslam.run(
            os.path.join(data_dir, "range_aided_slam_test_3d.pyfg")),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_chordal_example_driver_matches_jax(grid):
    from dcora_tpu.drivers import chordal_initialization_example as jex
    from dcora_tpu_torch.drivers import chordal_initialization_example as tex

    Tj, fj = jex.run(grid, verbose=False)
    Tt, ft = tex.run(grid, verbose=False, device="cpu")
    assert ft == pytest.approx(fj, rel=1e-10)
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-10 * np.abs(Tj).max())
