"""The PyTorch port's config.py against the JAX package's: the cases of
tests/test_config.py on the port's DcoraConfig, the same dump() for the
same --set overrides, and --config / --set on each of the seven drivers'
main(), where an explicit driver flag wins over the config
(config.resolve)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dcora_tpu.config as jconfig
import dcora_tpu.datasets as jds
from dcora_tpu_torch.config import DcoraConfig, resolve
from dcora_tpu_torch.drivers import (
    multi_robot_pgo,
    multi_robot_raslam,
    parallel_pgo,
    parallel_raslam,
    single_robot_gnc,
    single_robot_pgo,
    single_robot_raslam,
)
from dcora_tpu_torch.types import RobustCostType


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's solver loops issue tiny ops, which a thread pool beside
    the other test workers slows down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OVERRIDES = ["ropt.gradnorm_tol=1e-6", "staircase.r_max=12",
             "rbcd.acceleration=false", "robust.costType=GNC_TLS",
             "rbcd.block_selection_rule=Uniform", "staircase.num_lanczos=32"]


def test_defaults_match_reference():
    d = dict(DcoraConfig().items())
    # reference defaults (DCORA_robust.h:53-63, Agent.h:119-123,
    # MultiRobotExample.cpp:123-133)
    assert d["robust.GNCBarc"] == 5.0
    assert d["robust.GNCMuStep"] == 1.4
    assert d["robust.GNCInitMu"] == 1e-4
    assert d["rbcd.rel_change_tol"] == 5e-3
    assert d["rbcd.max_num_iters"] == 500
    assert d["rbcd.restart_interval"] == 30
    assert d["staircase.min_eig_num_tol"] == 1e-3
    assert d["rbcd.rgrad_norm_tol"] == 0.1


def test_dotted_overrides_and_coercion():
    cfg = DcoraConfig()
    cfg.override("ropt.gradnorm_tol", "1e-6")
    cfg.override("staircase.r_max", "12")
    cfg.override("rbcd.acceleration", "false")
    cfg.override("robust.costType", "GNC_TLS")
    assert cfg.ropt.gradnorm_tol == 1e-6
    assert cfg.staircase.r_max == 12
    assert cfg.rbcd.acceleration is False
    assert cfg.robust.costType == RobustCostType.GNC_TLS
    with pytest.raises(KeyError):
        cfg.override("staircase.nope", "1")
    with pytest.raises(KeyError):
        cfg.override("nogroup.x", "1")
    with pytest.raises(KeyError):
        cfg.override("nodot", "1")
    with pytest.raises(ValueError):
        cfg.override("robust.costType", "NOT_A_COST")
    with pytest.raises(ValueError):
        cfg.override("rbcd.acceleration", "maybe")
    dump = cfg.dump()
    assert "staircase.r_max = 12" in dump
    assert "robust.costType = GNC_TLS" in dump


def test_config_file_then_cli_override(tmp_path):
    path = tmp_path / "run.json"
    path.write_text(json.dumps({"ropt.RTR_iterations": 50,
                                "staircase.r_min": 3}))
    args = SimpleNamespace(config=str(path),
                           config_overrides=["staircase.r_min=4"])
    cfg = DcoraConfig.from_cli(args)
    assert cfg.ropt.RTR_iterations == 50
    assert cfg.staircase.r_min == 4  # CLI wins over file
    with pytest.raises(ValueError):
        DcoraConfig.from_cli(SimpleNamespace(config="",
                                             config_overrides=["nokv"]))


@pytest.mark.parametrize("n_overrides", [0, 1, len(OVERRIDES)])
def test_dump_equals_jax(tmp_path, n_overrides):
    """The same file and --set overrides give the JAX package's dump."""
    path = tmp_path / "run.json"
    path.write_text(json.dumps({"ropt.RTR_iterations": 50,
                                "robust.GNCMuStep": 1.2}))
    args = SimpleNamespace(config=str(path),
                           config_overrides=OVERRIDES[:n_overrides])
    assert DcoraConfig.from_cli(args).dump() == \
        jconfig.DcoraConfig.from_cli(args).dump()
    assert dict(DcoraConfig().items()).keys() == \
        dict(jconfig.DcoraConfig().items()).keys()


def test_resolve_precedence():
    assert resolve(None, 7) == 7
    assert resolve(3, 7) == 3
    assert resolve(0, 7) == 0  # an explicit zero is a value


def _fake_result():
    return SimpleNamespace(certified=True, final_rank=5, total_iters=1,
                           cost_trace=[1.0], elapsed_s=0.0)


# driver, argv (before the config flags), the run keyword the override
# reaches and its expected value, the driver flag that wins over it
DRIVERS = {
    "single_robot_pgo": (single_robot_pgo, ["x.g2o"], "staircase.r_max=7",
                         lambda kw: kw["r_max"], 7, ["--r-max", "4"], 4),
    "single_robot_raslam": (single_robot_raslam, ["x.pyfg"],
                            "staircase.r_max=7", lambda kw: kw["r_max"], 7,
                            ["--rmax", "4"], 4),
    "single_robot_gnc": (single_robot_gnc, ["x.g2o"], "robust.GNCBarc=7",
                         lambda kw: kw["robust_params"].GNCBarc, 7.0,
                         ["--gnc-barc", "4"], 4.0),
    "multi_robot_pgo": (multi_robot_pgo, ["3", "x.g2o"], "rbcd.num_iters=7",
                        lambda kw: kw["num_iters"], 7, ["--iters", "4"], 4),
    "multi_robot_raslam": (multi_robot_raslam, ["x.pyfg"],
                           "rbcd.num_iters=7", lambda kw: kw["num_iters"], 7,
                           ["--iters", "4"], 4),
    "parallel_pgo": (parallel_pgo, ["3", "x.g2o"], "rbcd.num_iters=7",
                     lambda kw: kw["max_rounds"], 7, ["--rounds", "4"], 4),
    "parallel_raslam": (parallel_raslam, ["x.pyfg"], "rbcd.num_iters=7",
                        lambda kw: kw["max_rounds"], 7, ["--rounds", "4"], 4),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_set_reaches_run(monkeypatch, caplog, name):
    module, argv, override, get, want, flag, flag_want = DRIVERS[name]
    calls = []

    def fake_run(*args, **kw):
        calls.append(kw)
        return _fake_result()

    monkeypatch.setattr(module, "run", fake_run)
    base = argv + ["--device", "cpu"]
    with caplog.at_level("INFO"):
        module.main(base + ["--set", override])
    assert get(calls[-1]) == want
    assert f"{override.split('=')[0]} = " in caplog.text  # the dump
    module.main(base + flag + ["--set", override])
    assert get(calls[-1]) == flag_want  # the explicit flag wins
    module.main(base)
    assert get(calls[-1]) == get_default(name)


def get_default(name):
    """What each driver passes when neither a flag nor the config is set:
    the config's defaults (the RA staircase caps r_max at 20)."""
    cfg = DcoraConfig()
    return {"single_robot_pgo": cfg.staircase.r_max,
            "single_robot_raslam": min(cfg.staircase.r_max, 20),
            "single_robot_gnc": cfg.robust.GNCBarc,
            "multi_robot_pgo": cfg.rbcd.num_iters,
            "multi_robot_raslam": cfg.rbcd.num_iters,
            "parallel_pgo": cfg.rbcd.num_iters,
            "parallel_raslam": cfg.rbcd.num_iters}[name]


def test_single_robot_pgo_main_solves_with_the_config(tmp_path):
    """main(["--set", ...]) reaches the real run: the staircase certifies
    tinyGrid3D at the configured tolerance."""
    path = str(tmp_path / "tiny.g2o")
    jds.generate_grid_g2o(path, **jds._TEST_SETS["tinyGrid3D.g2o"])
    T, f = single_robot_pgo.main([path, "--certify", "--device", "cpu",
                                  "--set", "staircase.r_max=6",
                                  "--set", "ropt.gradnorm_tol=1e-6"])
    assert T.shape == (8, 3, 4) and np.isfinite(T).all() and f > 0
