"""The DCORA_RA_PRECOND / DCORA_PGO_PRECOND overrides of rtr_fast's tile
preconditioner in the PyTorch port (dcora_tpu/solvers.py:150-170), on the
generated smallGrid3D set and a small generated RA-SLAM set.  rtr_fast
under the overrides, against the JAX package:
tests/test_torch_solver_precond.py."""

import pytest

import dcora_tpu.core.graph as jgraph
import dcora_tpu.core.init as jinit
import dcora_tpu.core.lifted as jlifted
import dcora_tpu.datasets as jds
import dcora_tpu.io as jio
import dcora_tpu.io.remap as jremap
import dcora_tpu.types as jtypes
from dcora_tpu_torch import solvers as tsolvers
from torch_port_common import jax_state


# env settings -> build_tiled's tile_precond on an RA and on a PGO problem
# (dcora_tpu/solvers.py:150-170); None: the PGO graph-shape rule (BTD when
# loop closures per pose < 0.2, else per-pose Jacobi)
TABLE = [
    ({}, "btd", None),
    ({"DCORA_RA_PRECOND": "btd"}, "btd", None),
    ({"DCORA_RA_PRECOND": "tile"}, True, None),
    ({"DCORA_RA_PRECOND": "other"}, True, None),
    ({"DCORA_RA_PRECOND": "pose"}, None, None),
    ({"DCORA_PGO_PRECOND": "btd"}, "btd", "btd"),
    ({"DCORA_PGO_PRECOND": "tile"}, "btd", True),
    ({"DCORA_PGO_PRECOND": "pose"}, "btd", False),
    ({"DCORA_RA_PRECOND": "pose", "DCORA_PGO_PRECOND": "tile"}, True, True),
]


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    d = tmp_path_factory.mktemp("opts")
    pgo = jds.generate_grid_g2o(str(d / "small.g2o"),
                                **jds._TEST_SETS["smallGrid3D.g2o"])
    ra = jds.generate_ra_slam_pyfg(str(d / "ra.pyfg"), num_robots=2,
                                   poses_per_robot=12, rot_noise=0.01,
                                   trans_noise=0.01, range_noise=0.01)
    return dict(pgo=pgo, ra=ra)


def _graphs(kind, path):
    """(JAX graph, port graph, JAX init, port init) of a set."""
    from dcora_tpu_torch.core import lifted as tlifted
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.drivers.single_robot_raslam import (
        odometry_init_global)
    from dcora_tpu_torch.io import read_g2o_file, read_pyfg_file
    from dcora_tpu_torch.io.remap import get_global_measurements
    from dcora_tpu_torch.types import GraphType

    if kind == "pgo":
        ms = jio.read_g2o_file(path).pose_pose_measurements
        gj = jgraph.LocalGraph(0, 5, 3)
        gj.set_measurements(ms)
        T = jinit.chordal_initialization(ms)
        gt = LocalGraph(0, 5, 3)
        gt.set_measurements(read_g2o_file(path).pose_pose_measurements)
        return (gj, gt, jlifted.pad_rank(jlifted.from_pose_array(T), 5),
                tlifted.pad_rank(tlifted.from_pose_array(T), 5))
    ds = read_pyfg_file(path)
    gm = get_global_measurements(ds)
    gt = LocalGraph(0, 3, 3, GraphType.RangeAidedSLAMGraph)
    gt.set_measurements(gm.relative_measurements)
    gj = jgraph.LocalGraph(0, 3, 3, jtypes.GraphType.RangeAidedSLAMGraph)
    gj.set_measurements(jremap.get_global_measurements(
        jio.read_pyfg_file(path)).relative_measurements)
    Xt = odometry_init_global(ds, gm)
    return gj, gt, jax_state(tuple(x.numpy() for x in Xt)), Xt


@pytest.mark.parametrize("row", range(len(TABLE)))
def test_tile_preconditioner_table(sets, monkeypatch, row):
    env, ra_want, pgo_want = TABLE[row]
    for key in ("DCORA_RA_PRECOND", "DCORA_PGO_PRECOND"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    _, gpgo, _, _ = _graphs("pgo", sets["pgo"])
    _, gra, _, _ = _graphs("ra", sets["ra"])
    rule_pgo = tsolvers._tile_preconditioner(
        gpgo, gpgo.problem_data(device="cpu"))
    got_ra = tsolvers._tile_preconditioner(gra, gra.problem_data(
        device="cpu"))
    for g, got, want in ((gpgo, rule_pgo, pgo_want), (gra, got_ra, ra_want)):
        if want is None:
            P = g.problem_data(device="cpu")
            lc = max(int(P.pp_ri.shape[0]) - (g.n - 1), 0) / g.n
            want = "btd" if lc < 0.2 else False
        assert got == want
