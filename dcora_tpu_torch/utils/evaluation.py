"""Trajectory evaluation: Umeyama alignment and absolute trajectory error
(counterpart of ``dcora_tpu.utils.evaluation``, the same numpy code).

The reference computes ATE outside its repo (trajectories are exported in
TUM format, Logger.cpp:107-145); BASELINE.md names ATE-vs-reference as a
north-star metric, so the evaluator lives in-tree here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning src -> dst.

    src/dst: [n, d] point sets. Returns (R, t, s) with
    dst ~= s * R @ src + t. Classic Umeyama (1991).
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    assert src.shape == dst.shape and src.ndim == 2
    n, d = src.shape
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    C = xd.T @ xs / n
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(d)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[d - 1, d - 1] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / n
        s = float(np.trace(np.diag(D) @ S) / var_s) if var_s > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(estimate: np.ndarray, ground_truth: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE over translations).

    estimate/ground_truth: [n, d] translation arrays, or [n, d, d+1] pose
    arrays (translations are extracted).
    """
    est = np.asarray(estimate, dtype=np.float64)
    gt = np.asarray(ground_truth, dtype=np.float64)
    if est.ndim == 3:
        est = est[:, :, -1]
    if gt.ndim == 3:
        gt = gt[:, :, -1]
    assert est.shape == gt.shape
    if align:
        R, t, s = umeyama_alignment(est, gt, with_scale=with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rotation_error_deg(R_est: np.ndarray, R_gt: np.ndarray,
                       R_align: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-pose geodesic rotation errors in degrees.

    R_est/R_gt: [n, d, d]. R_align optionally pre-rotates the estimate
    (e.g. the Umeyama R from the translation alignment).
    """
    R_est = np.asarray(R_est, dtype=np.float64)
    R_gt = np.asarray(R_gt, dtype=np.float64)
    if R_align is not None:
        R_est = np.einsum("ij,njk->nik", np.asarray(R_align), R_est)
    Rel = np.einsum("nij,nkj->nik", R_est, R_gt)  # R_est R_gt^T
    d = R_est.shape[-1]
    tr = np.trace(Rel, axis1=1, axis2=2)
    if d == 2:
        cos = np.clip(tr / 2.0, -1.0, 1.0)
    else:
        cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos))
