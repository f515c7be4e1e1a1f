"""Synthetic dataset generators (g2o pose graphs and PyFG RA-SLAM).

Counterpart of ``dcora_tpu.datasets``; the files it writes are byte for
byte those of the JAX package.  The reference ships 28 data files but no
generator (SURVEY.md section 2.1 row 18), so this module *generates*
structurally-equivalent datasets on demand:

  * grid pose graphs in the style of tinyGrid3D/smallGrid3D (boustrophedon
    trajectory over an axis-aligned grid, odometry plus spatially-adjacent
    loop closures), at any scale up to the g2o100k class used by the
    multi-host scaling benchmark;
  * tiny noiseless PGO sets for the fixed-point agent tests (the reference
    test strategy, testAgent.cpp:20 -- ground truth embedded as vertices);
  * noiseless RA-SLAM PyFG sets (poses + landmarks + range edges) in the
    reference's PyFG dialect (DCORA_utils.cpp:377-1167).

All generators are deterministic in their seed and write standard
g2o/PyFG text files (g2o reads back through io.read_g2o_file; the PyFG
reader is not ported yet).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from dcora_tpu_torch.utils.rotations import rotation_to_quat


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
    """Grid-visiting order that moves one unit step at a time (snake order
    over x, alternating direction per y row, alternating y per z layer)."""
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


def _info_upper(I: np.ndarray) -> str:
    """Upper-triangular row-major serialization of a 6x6 information
    matrix (g2o EDGE_SE3:QUAT convention)."""
    vals = []
    for i in range(6):
        for j in range(i, 6):
            vals.append(f"{I[i, j]:.12g}")
    return " ".join(vals)


def generate_grid_g2o(
    path: str,
    shape: Tuple[int, int, int] = (5, 5, 5),
    rot_noise: float = 0.05,
    trans_noise: float = 0.02,
    loop_radius: float = 1.01,
    loop_prob: float = 0.3,
    seed: int = 42,
    kappa: Optional[float] = None,
    tau: Optional[float] = None,
) -> str:
    """3D grid pose graph in the tinyGrid3D/smallGrid3D style.

    Poses sit on a gx*gy*gz unit grid visited in snake order; consecutive
    poses get odometry edges, and pairs of non-consecutive poses within
    ``loop_radius`` get loop closures with probability ``loop_prob``.
    ``rot_noise``/``trans_noise`` are the per-edge noise scales; zero noise
    produces a noiseless set whose vertices are the exact global optimum.
    Precisions are the isotropic kappa = 1/sigma_R^2, tau = 1/sigma_t^2
    (clamped for the noiseless case).
    """
    rng = np.random.default_rng(seed)
    pts = _boustrophedon(shape)
    n = len(pts)
    # smooth ground-truth orientations along the path
    Rs = [np.eye(3)]
    for _ in range(1, n):
        Rs.append(Rs[-1] @ _rand_rotation(rng, 0.5))
    Rs = np.stack(Rs)

    kappa = kappa if kappa is not None else 1.0 / max(rot_noise**2, 1e-6)
    tau = tau if tau is not None else 1.0 / max(trans_noise**2, 1e-6)
    I = np.zeros((6, 6))
    I[:3, :3] = tau * np.eye(3)
    # the g2o information->kappa conversion is kappa = 3/(2*tr(inv(I_R)))
    # = I_R/2 for isotropic blocks, so write 2*kappa to round-trip exactly
    I[3:, 3:] = 2.0 * kappa * np.eye(3)
    info = _info_upper(I)

    edges = []
    for i in range(n - 1):
        edges.append((i, i + 1))
    # loop-closure candidates via integer-grid offsets: poses sit on grid
    # points, so every pair within loop_radius differs by one of a bounded
    # set of integer offsets -- O(n * #offsets) instead of the previous
    # [n, n] distance matrix (212 GiB at the g2o100k scale)
    import itertools

    ipts = np.rint(pts).astype(np.int64)
    idx_of = {tuple(p): i for i, p in enumerate(ipts)}
    # the offset-bucket search assumes one pose per grid point (true for
    # the boustrophedon path); a revisiting trajectory would silently
    # drop candidate pairs, so make the assumption explicit.
    # NOTE: this O(n) search draws rng.uniform() in a different order than
    # the earlier O(n^2) scan, so identical seeds generate different
    # datasets than pre-round-2 artifacts recorded.
    assert len(idx_of) == n, "grid generator requires unique grid points"
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


def generate_noiseless_pgo_g2o(path: str, n: int = 6, d: int = 3,
                               seed: int = 7) -> str:
    """Tiny noiseless pose graph whose vertex poses are the exact global
    optimum (the reference's fixed-point test fixture style,
    testAgent.cpp:20-28)."""
    return generate_grid_g2o(
        path, shape=(n, 1, 1), rot_noise=0.0, trans_noise=0.0,
        loop_radius=2.01, loop_prob=1.0, seed=seed,
        kappa=1e4, tau=1e2,
    )


def generate_ra_slam_pyfg(
    path: str,
    num_robots: int = 2,
    poses_per_robot: int = 6,
    num_landmarks: int = 2,
    range_prob: float = 0.5,
    rot_noise: float = 0.0,
    trans_noise: float = 0.0,
    range_noise: float = 0.0,
    seed: int = 3,
) -> str:
    """Noiseless (by default) multi-robot RA-SLAM set in PyFG format:
    per-robot odometry chains, cross-robot loop closures, pose-landmark
    edges, and pose-pose / pose-landmark range measurements.

    Symbols follow the reference convention (DCORA_utils.cpp:377-455):
    robots 'A','B',... ; landmarks 'L0','L1',... owned by the map robot.
    """
    rng = np.random.default_rng(seed)
    assert num_robots <= 12  # 'A'..'L' would collide with landmark symbol

    # ground truth: parallel snake trajectories, one lane per robot
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
        # no timestamp on landmark vertices (DCORA_utils.cpp:741)
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

    # odometry
    for r in range(num_robots):
        for i in range(poses_per_robot - 1):
            R_ij = rots[r][i].T @ rots[r][i + 1]
            t_ij = rots[r][i].T @ (traj[r][i + 1] - traj[r][i])
            lines.append(
                rel_pose_line("EDGE_SE3:QUAT", sym(r, i), sym(r, i + 1),
                              R_ij, t_ij))
    # cross-robot loop closures (every aligned index pair)
    for r in range(num_robots - 1):
        for i in range(0, poses_per_robot, 2):
            R_ij = rots[r][i].T @ rots[r + 1][i]
            t_ij = rots[r][i].T @ (traj[r + 1][i] - traj[r][i])
            lines.append(
                rel_pose_line("EDGE_SE3:QUAT", sym(r, i), sym(r + 1, i),
                              R_ij, t_ij))
    # pose-landmark edges
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
    # range measurements: pose-pose (cross robot) and pose-landmark
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


# --------------------------------------------------------------------- cache

#: files the test-suite needs, with their generator configs
_TEST_SETS = {
    "tinyGrid3D.g2o": dict(shape=(2, 2, 2), rot_noise=0.05,
                           trans_noise=0.02, seed=11),
    "smallGrid3D.g2o": dict(shape=(5, 5, 5), rot_noise=0.05,
                            trans_noise=0.02, seed=12),
}


def write_g2o(path: str, measurements, dim: int) -> str:
    """Serialize pose-pose measurements back to g2o with isotropic
    information blocks chosen so the parser round-trips (kappa, tau)
    exactly (inverse of the io.g2o conversion rules, which mirror
    DCORA_utils.cpp:179-375):

      3D: I_t = tau*I3 (tau = 3/trace(inv(I_t))),
          I_R = 2*kappa*I3 (kappa = 3/(2*trace(inv(I_R))))
      2D: I_t = tau*I2 (tau = 2/trace(inv(I_t))), I33 = kappa
    """
    lines = []
    if dim == 3:
        for m in measurements:
            q = rotation_to_quat(np.asarray(m.R))
            t = np.asarray(m.t)
            info = np.zeros((6, 6))
            info[:3, :3] = m.tau * np.eye(3)
            info[3:, 3:] = 2.0 * m.kappa * np.eye(3)
            lines.append(
                f"EDGE_SE3:QUAT {m.p1} {m.p2} "
                f"{t[0]:.12g} {t[1]:.12g} {t[2]:.12g} "
                f"{q[0]:.12g} {q[1]:.12g} {q[2]:.12g} {q[3]:.12g} "
                f"{_info_upper(info)}"
            )
    else:
        for m in measurements:
            R = np.asarray(m.R)
            theta = float(np.arctan2(R[1, 0], R[0, 0]))
            t = np.asarray(m.t)
            # upper triangle of [[tau,0,0],[.,tau,0],[.,.,kappa]]
            lines.append(
                f"EDGE_SE2 {m.p1} {m.p2} "
                f"{t[0]:.12g} {t[1]:.12g} {theta:.12g} "
                f"{m.tau:.12g} 0 0 {m.tau:.12g} 0 {m.kappa:.12g}"
            )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def corrupt_with_outliers(measurements, frac: float = 0.15, seed: int = 7):
    """Plant gross outlier loop closures into a PGO measurement list
    (the testRobust.cpp:228-309 pattern at benchmark scale): add
    frac * (#loop closures) new random-pair edges with random rotations
    and gross random translations.  Returns (corrupted_list,
    outlier_keys) where outlier_keys is the set of (p1, p2) pairs of the
    planted edges (ground-truth labels for precision/recall)."""
    from dcora_tpu_torch.measurements import RelativePosePoseMeasurement

    rng = np.random.default_rng(seed)
    lcs = [m for m in measurements if not m.fixedWeight]
    n = 1 + max(max(m.p1, m.p2) for m in measurements)
    d = measurements[0].t.shape[0]
    num_out = int(round(frac * len(lcs)))
    kappa = float(np.median([m.kappa for m in lcs])) if lcs else 1e4
    tau = float(np.median([m.tau for m in lcs])) if lcs else 1e2
    existing = {(m.p1, m.p2) for m in measurements}
    out = list(measurements)
    outlier_keys = set()
    while len(outlier_keys) < num_out:
        i = int(rng.integers(n))
        j = int(rng.integers(n))
        if abs(i - j) <= 1 or (min(i, j), max(i, j)) in existing:
            continue
        i, j = min(i, j), max(i, j)
        if d == 3:
            R = _rand_rotation(rng, np.pi)
        else:
            th = rng.uniform(-np.pi, np.pi)
            R = np.array([[np.cos(th), -np.sin(th)],
                          [np.sin(th), np.cos(th)]])
        t = rng.uniform(-10.0, 10.0, size=d)
        out.append(RelativePosePoseMeasurement(
            r1=0, p1=i, r2=0, p2=j, R=R, t=t, kappa=kappa, tau=tau,
            fixedWeight=False,
        ))
        existing.add((i, j))
        outlier_keys.add((i, j))
    return out, outlier_keys


def ensure_test_datasets(cache_dir: str) -> str:
    """Generate the test-suite dataset files into ``cache_dir`` (if not
    already present) and return the directory.  Used as the fallback when
    the reference data mount is unavailable, so `pytest` runs
    self-contained."""
    os.makedirs(cache_dir, exist_ok=True)
    for name, cfg in _TEST_SETS.items():
        p = os.path.join(cache_dir, name)
        if not os.path.exists(p):
            generate_grid_g2o(p, **cfg)
    p = os.path.join(cache_dir, "pose_graph_optimization_test_3d.g2o")
    if not os.path.exists(p):
        generate_noiseless_pgo_g2o(p)
    p = os.path.join(cache_dir, "range_aided_slam_test_3d.pyfg")
    if not os.path.exists(p):
        generate_ra_slam_pyfg(p)
    return cache_dir


def generate_large_scale_g2o(path: str, target_poses: int = 100_000,
                             seed: int = 100) -> str:
    """g2o100k-class grid for the multi-host scaling benchmark
    (BASELINE.json: >=70% scaling efficiency at N>=2 hosts on g2o100k).
    The reference tops out at city10000; this generates a 10x larger
    problem with the same edge structure."""
    side = int(round(target_poses ** (1.0 / 3.0)))
    return generate_grid_g2o(
        path, shape=(side, side, side), rot_noise=0.05, trans_noise=0.02,
        loop_prob=0.2, seed=seed,
    )
