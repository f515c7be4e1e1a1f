"""The RA-SLAM host layer of the PyTorch port vs the JAX package: the PyFG
parser, the local<->global remapping, the SE(d) helpers, ``lift``,
``random_oblique`` and the RA driver's odometry initialization.

Inputs are generated PyFG files (``generate_ra_slam_pyfg``, numpy seeds)
plus one hand-written planar file with priors, read by both packages.  The
port's numpy parser is the JAX package's numpy path, so with the native
libraries switched off the parsed arrays are identical to that path's; the
port's default reader (its native build) against the JAX package's native
parser, when it is built, agrees to 1e-12 relative (the C++ number parsing
may differ from numpy's in the last ulp).  The remapped states and the
initialization agree to 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dcora_tpu.core.lifted as jlifted
import dcora_tpu.datasets as jds
import dcora_tpu.drivers.single_robot_raslam as jdrv
import dcora_tpu.io.pyfg as jpyfg
import dcora_tpu.io.remap as jremap
import dcora_tpu_torch.core.lifted as tlifted
import dcora_tpu_torch.core.manifold as tman
import dcora_tpu_torch.drivers.single_robot_raslam as tdrv
import dcora_tpu_torch.io.remap as tremap
from dcora_tpu import native
from dcora_tpu_torch.io import read_pyfg_file
from torch_port_common import assert_close, np_of

# name -> generate_ra_slam_pyfg keyword arguments
SETS = {
    "default": dict(),
    "noisy": dict(num_robots=3, poses_per_robot=9, num_landmarks=0,
                  range_prob=0.8, rot_noise=0.05, trans_noise=0.02,
                  range_noise=0.02, seed=4),
    "landmarks_ranges": dict(num_robots=4, poses_per_robot=12,
                             num_landmarks=5, range_prob=1.0,
                             rot_noise=0.03, trans_noise=0.01,
                             range_noise=0.01, seed=7),
}

# a planar file with every record type the parser reads, priors included
PLANAR = """\
VERTEX_SE2 0.0 A0 0.0 0.0 0.0
VERTEX_SE2 1.0 A1 1.0 0.1 0.2
VERTEX_SE2 2.0 A2 2.0 0.3 0.5
VERTEX_SE2 0.0 B0 0.0 2.0 -0.1
VERTEX_SE2 1.0 B1 1.1 2.1 0.1
VERTEX_XY L0 1.5 1.0
VERTEX_XY LB1 0.5 3.0
VERTEX_SE2:PRIOR 0.0 A0 0.0 0.0 0.0 0.01 0 0 0.01 0 0.001
VERTEX_XY:PRIOR 0.0 L0 1.5 1.0 0.02 0 0.02
EDGE_SE2 1.0 A0 A1 1.0 0.1 0.2 0.01 0 0 0.01 0 0.001
EDGE_SE2 2.0 A1 A2 1.0 0.2 0.3 0.01 0 0 0.01 0 0.001
EDGE_SE2 1.0 B0 B1 1.1 0.1 0.2 0.01 0 0 0.01 0 0.001
EDGE_SE2 1.0 A1 B1 0.1 2.0 -0.1 0.02 0 0 0.02 0 0.002
EDGE_SE2_XY 1.0 A2 L0 -0.4 0.7 0.03 0 0.03
EDGE_SE2_XY 1.0 B1 LB1 -0.6 0.9 0.03 0 0.03
EDGE_RANGE 1.0 A0 B0 2.0 0.0001
EDGE_RANGE 1.0 A2 L0 0.95 0.0002
EDGE_RANGE 1.0 B0 A2 2.2 0.0001
EDGE_RANGE 1.0 A2 B0 2.2 0.0001
"""


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pyfg")
    out = {name: jds.generate_ra_slam_pyfg(str(tmp / f"{name}.pyfg"), **kw)
           for name, kw in SETS.items()}
    out["planar"] = str(tmp / "planar.pyfg")
    with open(out["planar"], "w") as fh:
        fh.write(PLANAR)
    return out


def _jax_numpy_parse(path, monkeypatch):
    """The JAX package's numpy parser (its native library switched off)."""
    with monkeypatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        return jpyfg.read_pyfg_file(path)


def _plain(obj):
    """A comparable tree of a measurement / dataset: dataclasses to dicts,
    arrays to lists, enums to names."""
    if dataclasses.is_dataclass(obj):
        return {"type": type(obj).__name__,
                **{f.name: _plain(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {repr(_plain(k)): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, set):
        return sorted(_plain(v) for v in obj)
    if hasattr(obj, "name") and hasattr(obj, "value"):  # enum
        return obj.name
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return np_of(obj).tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def _assert_same(a, b, rtol=0.0):
    """Two plain trees equal, floats to rtol relative."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b)
        for k in b:
            _assert_same(a[k], b[k], rtol)
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y, rtol)
    elif isinstance(b, float):
        assert abs(a - b) <= rtol * max(abs(b), 1.0), (a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("name", [*SETS, "planar"])
def test_parser_identical_to_numpy_path(paths, monkeypatch, name):
    ref = _jax_numpy_parse(paths[name], monkeypatch)
    monkeypatch.setenv("DCORA_NATIVE", "0")  # the port's numpy parser
    out = read_pyfg_file(paths[name])
    _assert_same(_plain(out), _plain(ref))
    assert out.dim == (2 if name == "planar" else 3)
    assert len(out.measurements.relative_measurements) > 0


@pytest.mark.parametrize("name", sorted(SETS))
def test_parser_matches_native(paths, name):
    """Against the JAX package's default reader (its native library when
    built): the same records, numbers to 1e-12."""
    ref = jpyfg.read_pyfg_file(paths[name])
    out = read_pyfg_file(paths[name])
    _assert_same(_plain(out), _plain(ref), rtol=1e-12)


def test_parser_skips_duplicate_ranges_and_decodes_symbols(paths):
    ds = read_pyfg_file(paths["planar"])
    ranges = ds.measurements.ranges()
    assert len(ranges) == 3  # "A2 B0" repeats "B0 A2"
    assert ds.robot_IDs == {0, 1, 12}  # A, B and the map robot (L0)
    assert ds.robot_id_to_num_unit_spheres == {0: 2, 1: 1, 12: 0}
    assert len(ds.measurements.pose_priors) == 1
    assert len(ds.measurements.landmark_priors) == 1
    u = ds.ground_truth.unit_spheres[ranges[0].unit_sphere_id()]
    np.testing.assert_allclose(np.linalg.norm(u), 1.0, atol=1e-15)


@pytest.fixture(scope="module")
def datasets_both(paths):
    """name -> (JAX dataset, port dataset) of the 3D sets, each package
    reading with its own default reader."""
    return {name: (jpyfg.read_pyfg_file(paths[name]),
                   read_pyfg_file(paths[name])) for name in SETS}


@pytest.mark.parametrize("name", sorted(SETS))
@pytest.mark.parametrize("reindex", [True, False])
def test_local_to_global_mapping(datasets_both, name, reindex):
    dj, dt = datasets_both[name]
    ref = jremap.get_local_to_global_state_mapping(dj, reindex)
    out = tremap.get_local_to_global_state_mapping(dt, reindex)
    _assert_same(_plain(out)["poses"], _plain(ref)["poses"])
    _assert_same(_plain(out)["landmarks"], _plain(ref)["landmarks"])
    _assert_same(_plain(out)["unit_spheres"], _plain(ref)["unit_spheres"])


@pytest.mark.parametrize("name", sorted(SETS))
def test_global_measurements(datasets_both, name):
    dj, dt = datasets_both[name]
    ref = jremap.get_global_measurements(dj)
    out = tremap.get_global_measurements(dt)
    _assert_same(_plain(out.relative_measurements),
                 _plain(ref.relative_measurements), rtol=1e-12)
    assert isinstance(out.ground_truth_init, tlifted.RAState)
    for a, b in zip(out.ground_truth_init, ref.ground_truth_init):
        assert_close(a, b, rtol=1e-12)
    assert out.ground_truth_init.rot.device.type == "cpu"


@pytest.mark.parametrize("name", sorted(SETS))
def test_robot_measurements_and_indices(datasets_both, name):
    dj, dt = datasets_both[name]
    ref = jremap.get_robot_measurements(dj)
    out = tremap.get_robot_measurements(dt)
    assert sorted(out) == sorted(ref)
    for robot in ref:
        for field in ("pose_priors", "landmark_priors",
                      "relative_measurements"):
            _assert_same(_plain(getattr(out[robot], field)),
                         _plain(getattr(ref[robot], field)), rtol=1e-12)
        for a, b in zip(out[robot].ground_truth_init,
                        ref[robot].ground_truth_init):
            assert_close(a, b, rtol=1e-12)
    idx_j = jremap.robot_global_indices(dj)
    idx_t = tremap.robot_global_indices(dt)
    assert sorted(idx_t) == sorted(idx_j)
    for robot in idx_j:
        for key in ("poses", "spheres", "landmarks"):
            np.testing.assert_array_equal(idx_t[robot][key],
                                          idx_j[robot][key])


@pytest.mark.parametrize("name", sorted(SETS))
def test_odometry_init_global(datasets_both, name):
    dj, dt = datasets_both[name]
    ref = jdrv.odometry_init_global(dj, jremap.get_global_measurements(dj))
    out = tdrv.odometry_init_global(dt, tremap.get_global_measurements(dt))
    for a, b in zip(out, ref):
        assert_close(a, b, rtol=1e-12)


def test_se_helpers_and_alignment():
    rng = np.random.default_rng(8)
    T = np.concatenate([np.stack([jds._rand_rotation(rng, np.pi)
                                  for _ in range(5)]),
                        rng.standard_normal((5, 3, 1))], axis=2)
    np.testing.assert_array_equal(tlifted.pose_identity(3),
                                  jlifted.pose_identity(3))
    np.testing.assert_allclose(tlifted.pose_inverse(T[0]),
                               jlifted.pose_inverse(T[0]), rtol=0, atol=0)
    np.testing.assert_allclose(tlifted.pose_multiply(T[0], T[1]),
                               jlifted.pose_multiply(T[0], T[1]), rtol=0,
                               atol=0)
    np.testing.assert_allclose(tdrv.align_trajectory_to_frame(T, T[2]),
                               jdrv.align_trajectory_to_frame(T, T[2]),
                               rtol=0, atol=0)
    # the frame's own pose aligns to the identity
    np.testing.assert_allclose(tdrv.align_trajectory_to_frame(T, T[2])[2],
                               tlifted.pose_identity(3), atol=1e-14)


def test_lift():
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    rot = rng.standard_normal((4, 3, 3))
    sph = rng.standard_normal((2, 3))
    trn = rng.standard_normal((5, 3))
    Y = np.linalg.qr(rng.standard_normal((6, 3)))[0]
    ref = jlifted.lift(jlifted.RAState(*map(jnp.asarray, (rot, sph, trn))),
                       jnp.asarray(Y))
    out = tlifted.lift(tlifted.RAState(*map(torch.as_tensor,
                                            (rot, sph, trn))),
                       torch.as_tensor(Y))
    for a, b in zip(out, ref):
        assert_close(a, b, rtol=1e-14)
    assert out.r == 6


def test_random_oblique():
    """Unit rows, reproducible from the generator (jax.random's stream is
    not reproduced: the JAX and port draws differ by design)."""
    S = tman.random_oblique(7, 5, torch.Generator().manual_seed(3))
    assert S.shape == (7, 5) and S.dtype == torch.float64
    np.testing.assert_allclose(np_of(torch.linalg.vector_norm(S, dim=1)),
                               1.0, atol=1e-15)
    assert torch.equal(S, tman.random_oblique(
        7, 5, torch.Generator().manual_seed(3)))
    assert not torch.equal(S, tman.random_oblique(
        7, 5, torch.Generator().manual_seed(4)))
