"""Frozen copies of the port's dataset generators.

``grid_g2o`` is ``dcora_tpu_torch.datasets.generate_grid_g2o`` and
``ra_slam_pyfg`` is ``dcora_tpu_torch.datasets.generate_ra_slam_pyfg``, with
the helpers they call (``utils.rotations.rotation_to_quat`` among them),
copied so that the benchmark's inputs stay what they are whatever later
changes make to the port.  For the same parameters and seed each writes the
port's file byte for byte (``port_bench/tests/test_bench_generators.py``).
``renoise_g2o`` is the benchmark's own: it measures a fixed graph again
under noise drawn by the run's seed.  Only numpy is imported.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np


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


def _rand_rotation(rng: np.random.Generator, max_angle: float) -> np.ndarray:
    """Random 3D rotation with angle uniform in [0, max_angle]."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(0.0, max_angle)
    K = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _boustrophedon(shape: Tuple[int, int, int]) -> np.ndarray:
    """Grid-visiting order that moves one unit step at a time."""
    gx, gy, gz = shape
    coords = []
    for z in range(gz):
        ys = range(gy) if z % 2 == 0 else range(gy - 1, -1, -1)
        for yi, y in enumerate(ys):
            fwd = (yi % 2 == 0) == (z % 2 == 0)
            xs = range(gx) if fwd else range(gx - 1, -1, -1)
            for x in xs:
                coords.append((x, y, z))
    return np.array(coords, dtype=np.float64)


def _info_upper(I: np.ndarray) -> str:  # noqa: E741
    vals = []
    for i in range(6):
        for j in range(i, 6):
            vals.append(f"{I[i, j]:.12g}")
    return " ".join(vals)


def grid_g2o(path: str, shape=(5, 5, 5), rot_noise: float = 0.05,
             trans_noise: float = 0.02, loop_radius: float = 1.01,
             loop_prob: float = 0.3, seed: int = 42, kappa=None,
             tau=None) -> str:
    """3D grid pose graph: poses on a gx*gy*gz unit grid in snake order,
    odometry between consecutive poses, and a loop closure with
    probability ``loop_prob`` between non-consecutive poses within
    ``loop_radius``; isotropic kappa = 1/rot_noise^2, tau =
    1/trans_noise^2."""
    rng = np.random.default_rng(seed)
    pts = _boustrophedon(tuple(shape))
    n = len(pts)
    Rs = [np.eye(3)]
    for _ in range(1, n):
        Rs.append(Rs[-1] @ _rand_rotation(rng, 0.5))
    Rs = np.stack(Rs)

    kappa = kappa if kappa is not None else 1.0 / max(rot_noise**2, 1e-6)
    tau = tau if tau is not None else 1.0 / max(trans_noise**2, 1e-6)
    I = np.zeros((6, 6))  # noqa: E741
    I[:3, :3] = tau * np.eye(3)
    I[3:, 3:] = 2.0 * kappa * np.eye(3)
    info = _info_upper(I)

    edges = [(i, i + 1) for i in range(n - 1)]
    ipts = np.rint(pts).astype(np.int64)
    idx_of = {tuple(p): i for i, p in enumerate(ipts)}
    if len(idx_of) != n:
        raise ValueError("grid generator requires unique grid points")
    Rmax = int(np.floor(loop_radius))
    offsets = [
        o for o in itertools.product(range(-Rmax, Rmax + 1), repeat=3)
        if o != (0, 0, 0) and np.linalg.norm(o) <= loop_radius
    ]
    for i in range(n):
        base = ipts[i]
        for off in offsets:
            j = idx_of.get((base[0] + off[0], base[1] + off[1],
                            base[2] + off[2]))
            if j is not None and j > i + 1 and rng.uniform() < loop_prob:
                edges.append((i, j))

    lines = []
    for i in range(n):
        q = rotation_to_quat(Rs[i])
        x, y, z = pts[i]
        lines.append(
            f"VERTEX_SE3:QUAT {i} {x:.9f} {y:.9f} {z:.9f} "
            f"{q[0]:.12f} {q[1]:.12f} {q[2]:.12f} {q[3]:.12f}"
        )
    for (i, j) in edges:
        R_ij = Rs[i].T @ Rs[j]
        t_ij = Rs[i].T @ (pts[j] - pts[i])
        if rot_noise > 0:
            R_ij = R_ij @ _rand_rotation(rng, rot_noise)
        if trans_noise > 0:
            t_ij = t_ij + rng.normal(scale=trans_noise, size=3)
        q = rotation_to_quat(R_ij)
        lines.append(
            f"EDGE_SE3:QUAT {i} {j} "
            f"{t_ij[0]:.12f} {t_ij[1]:.12f} {t_ij[2]:.12f} "
            f"{q[0]:.12f} {q[1]:.12f} {q[2]:.12f} {q[3]:.12f} {info}"
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def ra_slam_pyfg(path: str, num_robots: int = 2, poses_per_robot: int = 6,
                 num_landmarks: int = 2, range_prob: float = 0.5,
                 rot_noise: float = 0.0, trans_noise: float = 0.0,
                 range_noise: float = 0.0, seed: int = 3) -> str:
    """Multi-robot RA-SLAM set in PyFG: one snake lane per robot with
    odometry, a loop closure between every second aligned pose of
    neighbouring robots, pose-landmark edges, and ranges between aligned
    poses of neighbouring robots and from every landmark."""
    rng = np.random.default_rng(seed)
    if num_robots > 12:
        raise ValueError("at most 12 robots ('A'..'L' would collide with "
                         "the landmark symbol)")

    traj = {}
    rots = {}
    for r in range(num_robots):
        pts = _boustrophedon((poses_per_robot, 1, 1))
        pts[:, 1] += 2.0 * r
        Rs = [np.eye(3)]
        for _ in range(1, poses_per_robot):
            Rs.append(Rs[-1] @ _rand_rotation(rng, 0.4))
        traj[r] = pts
        rots[r] = np.stack(Rs)
    lms = rng.uniform(-1, poses_per_robot, size=(num_landmarks, 3))
    lms[:, 1] = rng.uniform(-1, 2.0 * num_robots, size=num_landmarks)

    cov_t = 1e-4 if trans_noise == 0 else trans_noise**2
    cov_r = 1e-4 if rot_noise == 0 else rot_noise**2
    cov_rng = 1e-4 if range_noise == 0 else range_noise**2
    cov6 = np.zeros((6, 6))
    cov6[:3, :3] = cov_t * np.eye(3)
    cov6[3:, 3:] = cov_r * np.eye(3)

    def cov_upper(C, k):
        vals = []
        for i in range(k):
            for j in range(i, k):
                vals.append(f"{C[i, j]:.12g}")
        return " ".join(vals)

    def sym(r, i):
        return f"{chr(ord('A') + r)}{i}"

    lines = []
    ts = 0.0
    for r in range(num_robots):
        for i in range(poses_per_robot):
            q = rotation_to_quat(rots[r][i])
            x, y, z = traj[r][i]
            lines.append(
                f"VERTEX_SE3:QUAT {float(i):.1f} {sym(r, i)} "
                f"{x:.9f} {y:.9f} {z:.9f} "
                f"{q[0]:.12f} {q[1]:.12f} {q[2]:.12f} {q[3]:.12f}"
            )
    for k in range(num_landmarks):
        x, y, z = lms[k]
        lines.append(f"VERTEX_XYZ L{k} {x:.9f} {y:.9f} {z:.9f}")

    def rel_pose_line(tok, s1, s2, R_ij, t_ij):
        if rot_noise > 0:
            R_ij = R_ij @ _rand_rotation(rng, rot_noise)
        if trans_noise > 0:
            t_ij = t_ij + rng.normal(scale=trans_noise, size=3)
        q = rotation_to_quat(R_ij)
        return (
            f"{tok} {ts:.1f} {s1} {s2} "
            f"{t_ij[0]:.12f} {t_ij[1]:.12f} {t_ij[2]:.12f} "
            f"{q[0]:.12f} {q[1]:.12f} {q[2]:.12f} {q[3]:.12f} "
            f"{cov_upper(cov6, 6)}"
        )

    for r in range(num_robots):
        for i in range(poses_per_robot - 1):
            R_ij = rots[r][i].T @ rots[r][i + 1]
            t_ij = rots[r][i].T @ (traj[r][i + 1] - traj[r][i])
            lines.append(
                rel_pose_line("EDGE_SE3:QUAT", sym(r, i), sym(r, i + 1),
                              R_ij, t_ij))
    for r in range(num_robots - 1):
        for i in range(0, poses_per_robot, 2):
            R_ij = rots[r][i].T @ rots[r + 1][i]
            t_ij = rots[r][i].T @ (traj[r + 1][i] - traj[r][i])
            lines.append(
                rel_pose_line("EDGE_SE3:QUAT", sym(r, i), sym(r + 1, i),
                              R_ij, t_ij))
    cov3 = cov_t * np.eye(3)
    for k in range(num_landmarks):
        r = k % num_robots
        i = (2 * k) % poses_per_robot
        t_pl = rots[r][i].T @ (lms[k] - traj[r][i])
        if trans_noise > 0:
            t_pl = t_pl + rng.normal(scale=trans_noise, size=3)
        lines.append(
            f"EDGE_SE3_XYZ {ts:.1f} {sym(r, i)} L{k} "
            f"{t_pl[0]:.12f} {t_pl[1]:.12f} {t_pl[2]:.12f} "
            f"{cov_upper(cov3, 3)}"
        )
    for r in range(num_robots - 1):
        for i in range(poses_per_robot):
            if rng.uniform() < range_prob:
                dist = np.linalg.norm(traj[r + 1][i] - traj[r][i])
                if range_noise > 0:
                    dist += rng.normal(scale=range_noise)
                if dist > 0:
                    lines.append(
                        f"EDGE_RANGE {ts:.1f} {sym(r, i)} {sym(r + 1, i)} "
                        f"{dist:.12f} {cov_rng:.12g}"
                    )
    for k in range(num_landmarks):
        for r in range(num_robots):
            i = (3 * k + r) % poses_per_robot
            if rng.uniform() < range_prob:
                dist = np.linalg.norm(lms[k] - traj[r][i])
                if range_noise > 0:
                    dist += rng.normal(scale=range_noise)
                if dist > 0:
                    lines.append(
                        f"EDGE_RANGE {ts:.1f} {sym(r, i)} L{k} "
                        f"{dist:.12f} {cov_rng:.12g}"
                    )

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def renoise_g2o(path: str, rot_noise: float, trans_noise: float,
                seed: int) -> str:
    """Measure every edge of the g2o file at `path` again, in place: the
    same graph, vertices and information, each measurement drawn anew from
    the ground-truth vertices with grid_g2o's noise model (a rotation of
    angle up to rot_noise, Gaussian translation noise of scale
    trans_noise) by `seed`.  Not a copy of the port: the benchmark's own
    way to keep one fixed graph and draw its noise from the run's seed."""
    rng = np.random.default_rng(seed)
    with open(path) as f:
        lines = f.read().splitlines()
    Rs, pts = {}, {}
    out = []
    for line in lines:
        p = line.split()
        if p[0] == "VERTEX_SE3:QUAT":
            x, y, z, w = (float(v) for v in p[5:9])
            q = np.array([x, y, z, w]) / np.linalg.norm([x, y, z, w])
            x, y, z, w = q
            Rs[int(p[1])] = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)]])
            pts[int(p[1])] = np.array([float(v) for v in p[2:5]])
            out.append(line)
        elif p[0] == "EDGE_SE3:QUAT":
            i, j = int(p[1]), int(p[2])
            R_ij = Rs[i].T @ Rs[j] @ _rand_rotation(rng, rot_noise)
            t_ij = Rs[i].T @ (pts[j] - pts[i]) + rng.normal(
                scale=trans_noise, size=3)
            q = rotation_to_quat(R_ij)
            out.append(
                f"EDGE_SE3:QUAT {i} {j} "
                f"{t_ij[0]:.12f} {t_ij[1]:.12f} {t_ij[2]:.12f} "
                f"{q[0]:.12f} {q[1]:.12f} {q[2]:.12f} {q[3]:.12f} "
                + " ".join(p[10:]))
        else:
            raise ValueError(f"renoise_g2o: unknown record {p[0]!r}")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path


GENERATORS = {"grid_g2o": grid_g2o, "ra_slam_pyfg": ra_slam_pyfg}
