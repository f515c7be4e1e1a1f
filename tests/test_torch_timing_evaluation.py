"""utils.timing, utils.evaluation and verification.ate_vs_ground_truth of
the PyTorch port against the JAX package: the same Umeyama alignment, ATE
and rotation errors on seeded inputs (1e-12), and the timers' semantics of
tests/test_misc.py.  On the CPU the timers synchronize nothing; on a CUDA
tensor they synchronize its device (tests/test_torch_g2o100k_cuda.py)."""

import time

import numpy as np
import pytest
import torch

import dcora_tpu.utils.evaluation as jev
import dcora_tpu.verification as jver
import dcora_tpu_torch.utils.evaluation as tev
import dcora_tpu_torch.utils.timing as ttiming
import dcora_tpu_torch.verification as tver
from dcora_tpu.datasets import _rand_rotation

TOL = 1e-12


def _trajectory(rng, n=40, d=3, noise=0.0):
    T = np.zeros((n, d, d + 1))
    for i in range(n):
        T[i, :, :d] = _rand_rotation(rng, np.pi)
        T[i, :, d] = rng.standard_normal(d) * 5
    if noise:
        T[:, :, d] += noise * rng.standard_normal((n, d))
    return T


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("d", [2, 3])
def test_umeyama_matches_jax(with_scale, d):
    rng = np.random.default_rng(10 + d)
    src = rng.standard_normal((50, d)) * 3
    R = _rand_rotation(rng, np.pi) if d == 3 else np.array(
        [[np.cos(0.7), -np.sin(0.7)], [np.sin(0.7), np.cos(0.7)]])
    dst = 1.7 * (R @ src.T).T + rng.standard_normal(d) \
        + 0.01 * rng.standard_normal((50, d))
    got = tev.umeyama_alignment(src, dst, with_scale=with_scale)
    want = jev.umeyama_alignment(src, dst, with_scale=with_scale)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("align", [False, True])
def test_ate_and_rotation_errors_match_jax(align):
    rng = np.random.default_rng(3)
    gt = _trajectory(rng)
    est = gt.copy()
    est[:, :, 3] += 0.05 * rng.standard_normal((40, 3))
    est[:, :, :3] = np.einsum("ij,njk->nik", _rand_rotation(rng, 0.05),
                              est[:, :, :3])
    got = tev.ate_rmse(est, gt, align=align)
    want = jev.ate_rmse(est, gt, align=align)
    assert abs(got - want) <= TOL * max(abs(want), 1.0)
    R_align = tev.umeyama_alignment(est[:, :, 3], gt[:, :, 3])[0]
    np.testing.assert_allclose(
        tev.rotation_error_deg(est[:, :, :3], gt[:, :, :3], R_align),
        jev.rotation_error_deg(est[:, :, :3], gt[:, :, :3], R_align),
        rtol=TOL, atol=TOL)
    assert tver.ate_vs_ground_truth(est, gt) == jver.ate_vs_ground_truth(
        est, gt)


def test_rigid_copy_has_zero_ate():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((40, 3)) * 5
    R = _rand_rotation(rng, np.pi)
    t = rng.standard_normal(3)
    dst = (R @ pts.T).T + t
    R_est, t_est, s = tev.umeyama_alignment(pts, dst)
    np.testing.assert_allclose(R_est, R, atol=1e-10)
    np.testing.assert_allclose(t_est, t, atol=1e-10)
    assert s == 1.0
    assert tev.ate_rmse(pts, dst) < 1e-10
    noisy = dst + 0.01 * rng.standard_normal(dst.shape)
    assert 0.005 < tev.ate_rmse(noisy, dst, align=False) < 0.03


def test_phase_timer_and_simple_timer():
    t = ttiming.SimpleTimer()
    t.tic()
    time.sleep(0.01)
    assert t.toc() >= 5.0
    with pytest.raises(AssertionError):
        t.toc()  # toc() before tic()

    pt = ttiming.PhaseTimer()
    for _ in range(3):
        with pt.phase("work", block_on=(torch.zeros(2), {"x": [1.0]})):
            time.sleep(0.002)
    assert pt.count["work"] == 3
    assert pt.ms["work"] >= 3.0
    assert "work: " in pt.report() and "3 calls" in pt.report()
    with pytest.raises(ValueError):
        with pt.phase("fails"):
            raise ValueError
    assert pt.count["fails"] == 1  # a failing phase is still timed


def test_block_on_cpu_tensors_synchronizes_nothing(monkeypatch):
    """The pytree walk finds every tensor, and only CUDA ones synchronize."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    tree = {"a": torch.ones(3), "b": [torch.zeros(1), (torch.ones(2),)],
            "c": None, "d": 1.0}
    assert len(list(ttiming._tensors(tree))) == 3
    t = ttiming.SimpleTimer()
    t.tic()
    t.toc(block_on=tree)
    assert calls == []
