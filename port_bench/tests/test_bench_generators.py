"""The frozen generator copies write the port's files byte for byte."""

import filecmp

import pytest

from dcora_tpu_torch import datasets
from port_bench.reference import generators


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 13])
def test_grid_g2o_is_the_ports(tmp_path, seed):
    kw = dict(shape=(4, 3, 3), loop_prob=0.962, seed=seed)
    a = generators.grid_g2o(str(tmp_path / "a.g2o"), **kw)
    b = datasets.generate_grid_g2o(str(tmp_path / "b.g2o"), **kw)
    assert filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("seed", [3, 2**31 + 13])
def test_ra_slam_pyfg_is_the_ports(tmp_path, seed):
    kw = dict(num_robots=5, poses_per_robot=12, num_landmarks=4,
              range_prob=1.0, rot_noise=0.01, trans_noise=0.01,
              range_noise=0.01, seed=seed)
    a = generators.ra_slam_pyfg(str(tmp_path / "a.pyfg"), **kw)
    b = datasets.generate_ra_slam_pyfg(str(tmp_path / "b.pyfg"), **kw)
    assert filecmp.cmp(a, b, shallow=False)


def test_renoise_keeps_the_graph_and_draws_new_noise(tmp_path):
    a = generators.grid_g2o(str(tmp_path / "a.g2o"), shape=(4, 3, 3),
                            loop_prob=0.962, seed=199)
    before = open(a).read().splitlines()
    generators.renoise_g2o(a, 0.05, 0.02, seed=2**31 + 5)
    after = open(a).read().splitlines()
    assert len(after) == len(before)
    for x, y in zip(before, after):
        px, py = x.split(), y.split()
        if px[0] == "VERTEX_SE3:QUAT":
            assert x == y
        else:
            assert px[:3] == py[:3] and px[10:] == py[10:]
            assert px[3:10] != py[3:10]
    b = generators.grid_g2o(str(tmp_path / "b.g2o"), shape=(4, 3, 3),
                            loop_prob=0.962, seed=199)
    generators.renoise_g2o(b, 0.05, 0.02, seed=2**31 + 5)
    assert open(b).read() == "\n".join(after) + "\n"
