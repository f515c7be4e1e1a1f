"""The certified single-robot RA-SLAM slice, end to end on the CPU: the
PyTorch port's driver (``dcora_tpu_torch.drivers.single_robot_raslam.run``)
against the JAX package's (``dcora_tpu.drivers.single_robot_raslam.run``)
on the same generated PyFG files -- the same certified rank, f* (lifted and
rounded) to 1e-8 relative, and an LDL^T witness from the port's independent
verifier.

  * 150 poses (5 robots x 30, 120 ranges): below FAST_PATH_MIN_POSES, the
    f64 edge path only;
  * 100 poses (5 robots x 20, tests/test_torch_raslam_tiled.py, a file of
    its own so the two solves run on different test workers):
    FAST_PATH_MIN_POSES lowered in both packages for the test, so the f32
    and f64 tile phases run with the block-tridiagonal preconditioner, and
    every tile product goes through the strip layout's plain version (the
    kernel's CPU path).

The port runs with one intra-op thread: its many small tensor ops slow
down badly when several test workers share the CPU's cores.
"""

import numpy as np
import pytest
import torch

import dcora_tpu.datasets as jds
import dcora_tpu.solvers as jsolvers
import dcora_tpu_torch.core.tiled as ttiled
import dcora_tpu_torch.solvers as tsolvers
import dcora_tpu_torch.staircase as tstaircase
from dcora_tpu.core import problem as jprob
from dcora_tpu.drivers.single_robot_raslam import run as jrun
from dcora_tpu_torch.core import spmm
from dcora_tpu_torch.drivers.single_robot_raslam import run
from dcora_tpu_torch.tools.common import RA_KW
from dcora_tpu_torch.verification import verify_solution

ETA = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def check_slice(tmp_path, monkeypatch, poses_per_robot: int, path: str):
    """The port's RA driver against the JAX package's on the RA_KW set of
    `poses_per_robot` poses per robot, on the edge or the tiled path."""
    pyfg = jds.generate_ra_slam_pyfg(str(tmp_path / "ra.pyfg"),
                                     poses_per_robot=poses_per_robot,
                                     **RA_KW)
    if path == "tiled":
        for mod in (jsolvers, tsolvers, tstaircase):
            monkeypatch.setattr(mod, "FAST_PATH_MIN_POSES", 1)
    ref, gj, _ = jrun(pyfg, verbose=False)
    f_ref = float(jprob.cost(gj.problem_data(), ref.rounded))

    products, layouts = [], []
    real_apply, real_plain = ttiled.apply_tiled, spmm.spmm_strips_plain

    def counted_apply(TP, X):
        products.append(X.dtype)
        return real_apply(TP, X)

    def counted_plain(blocks, X):
        layouts.append(blocks.vals.shape[-1])
        return real_plain(blocks, X)

    monkeypatch.setattr(ttiled, "apply_tiled", counted_apply)
    monkeypatch.setattr(spmm, "spmm_strips_plain", counted_plain)
    res = {}
    st, g, gm = run(pyfg, device="cpu", verbose=False, result=res)

    assert ref.certified and st.certified
    assert st.final_rank == ref.final_rank
    np.testing.assert_allclose(st.f_final, ref.f_final, rtol=1e-8)
    np.testing.assert_allclose(res["f_rounded"], f_ref, rtol=1e-8)
    assert st.X.rot.device.type == "cpu" and g.l == gj.l > 0
    if path == "tiled":
        assert products and torch.float32 in products \
            and torch.float64 in products
        assert layouts == [spmm.BLOCK] * len(products)
    else:
        assert not products
    rep = verify_solution(gm.relative_measurements, st.X, 3, eta=ETA)
    assert rep["certified_indep"] is True


def test_raslam_slice_edge_path_matches_reference(tmp_path, monkeypatch):
    check_slice(tmp_path, monkeypatch, 30, "edge")


def test_driver_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    """The entry points default to the card and raise without one; the CPU
    runs only when asked for."""
    from dcora_tpu_torch.drivers import single_robot_raslam

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pyfg = jds.generate_ra_slam_pyfg(str(tmp_path / "ra.pyfg"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(pyfg, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        single_robot_raslam.main([pyfg])
    st, _, _ = run(pyfg, device="cpu", verbose=False)
    assert st.certified


def test_recorded_ra_reference_matches_the_generated_sets(tmp_path):
    """The RA fixture chip_smoke.py holds the card to: each entry was made
    from tools.common.ra_set's set (byte-identical to the JAX package's
    generator output); ra500 certified with the LDL^T witness at eta
    1e-4 (an entry the JAX package did not certify is recorded as such)."""
    import filecmp
    import json

    from dcora_tpu_torch.tools.common import ra_set
    from make_torch_port_reference import CASES, OUT_RA

    with open(OUT_RA) as fh:
        refs = json.load(fh)
    assert "ra500" in refs
    for name, rec in refs.items():
        per_robot = rec["kwargs"]["poses_per_robot"]
        assert CASES[name] == ("generate_ra_slam_pyfg", rec["kwargs"])
        assert rec["kwargs"] == dict(RA_KW, poses_per_robot=per_robot)
        assert rec["eta"] == ETA and rec["n"] == 5 * per_robot
        if name == "ra500":
            assert rec["certified"] and rec["ldl_witness"]
        if per_robot <= 100:
            ours = ra_set(str(tmp_path), per_robot)
            theirs = jds.generate_ra_slam_pyfg(str(tmp_path / "j.pyfg"),
                                               **rec["kwargs"])
            assert filecmp.cmp(ours, theirs, shallow=False)
