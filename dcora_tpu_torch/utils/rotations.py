"""Rotation conversions (host-side, numpy)."""

from __future__ import annotations

import numpy as np


def theta_to_rotation(theta) -> np.ndarray:
    """2D rotation matrix/matrices from angle(s). Scalar -> (2,2), (m,) -> (m,2,2)."""
    theta = np.asarray(theta, dtype=np.float64)
    c, s = np.cos(theta), np.sin(theta)
    R = np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], -2
    )
    return R


def quat_to_rotation(q) -> np.ndarray:
    """Rotation matrix from quaternion(s) in (qx, qy, qz, qw) order.

    Normalizes the quaternion first (matches Eigen::Quaterniond semantics for
    unit inputs; guards against file round-off). (4,) -> (3,3), (m,4) -> (m,3,3).
    """
    q = np.asarray(q, dtype=np.float64)
    single = q.ndim == 1
    if single:
        q = q[None]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((len(q), 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R[0] if single else R


def rotation_to_quat(R: np.ndarray) -> np.ndarray:
    """Quaternion (qx, qy, qz, qw) from a 3x3 rotation matrix (Shepperd)."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def angular_to_chordal_so3(rad: float) -> float:
    """2*sqrt(2)*sin(rad/2) (reference: DCORA_utils.cpp angular2ChordalSO3)."""
    return 2.0 * np.sqrt(2.0) * np.sin(rad / 2.0)
