"""The certified single-robot PGO slice, end to end on the CPU: the PyTorch
port's driver against the JAX package's staircase on the same generated
files -- the same certified rank and f* to 1e-8 relative, and an LDL^T
witness from the port's independent verifier.  The 512-pose grid runs its
tile products through the strip CSR of the default pack and, again, under
DCORA_SPMM_PACK=paired through the compacted two-row K-fused packs (the
plain versions of the two sub-block kernels on the CPU)."""

import json

import numpy as np
import pytest

import dcora_tpu.datasets as jds
import dcora_tpu_torch.core.tiled as ttiled
from dcora_tpu_torch.core import spmm
from dcora_tpu_torch.drivers.single_robot_pgo import run
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.solvers import FAST_PATH_MIN_POSES
from dcora_tpu_torch.verification import verify_solution
from make_torch_port_reference import OUT as REFERENCE_JSON
from make_torch_port_reference import solve as solve_reference

CASES = {
    # tinyGrid3D: 8 poses, the edge path only
    "tinyGrid3D": dict(shape=(2, 2, 2), rot_noise=0.05, trans_noise=0.02,
                       seed=11),
    # 512 poses: at FAST_PATH_MIN_POSES, so the tiled rtr_fast phases run
    "grid8": dict(shape=(8, 8, 8), rot_noise=0.05, trans_noise=0.02, seed=5),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """name -> (generated g2o path, JAX reference solve), each solved once
    per module."""
    cache = {}

    def get(name):
        if name not in cache:
            path = str(tmp_path_factory.mktemp(name) / f"{name}.g2o")
            jds.generate_grid_g2o(path, **CASES[name])
            cache[name] = (path, solve_reference(path))
        return cache[name]

    return get


def _port(path, monkeypatch, layouts=None):
    """Run the port's driver; count the tile products (apply_tiled) and,
    into `layouts`, the name of the sub-block layout each one read."""
    calls = []
    real = ttiled.apply_tiled

    def counted(TP, X):
        calls.append(X.dtype)
        return real(TP, X)

    monkeypatch.setattr(ttiled, "apply_tiled", counted)
    for name in ("spmm_strips_plain", "spmm_paired_plain"):
        def plain(blocks, X, name=name, real=getattr(spmm, name)):
            assert blocks.vals.shape[-1] == spmm.BLOCK
            if layouts is not None:
                layouts.append(name)
            return real(blocks, X)
        monkeypatch.setattr(spmm, name, plain)
    res = {}
    _, f = run(path, certify=True, device="cpu", verbose=False, result=res)
    return f, res["staircase"], calls


@pytest.mark.parametrize("name", sorted(CASES))
def test_slice_matches_reference(reference, monkeypatch, name):
    path, ref = reference(name)
    layouts = []
    f, st, calls = _port(path, monkeypatch, layouts)
    assert ref["certified"] and st.certified
    assert st.final_rank == ref["rank"]
    np.testing.assert_allclose(f, ref["f"], rtol=1e-8)
    np.testing.assert_allclose(st.f_final, ref["f_lifted"], rtol=1e-8)
    assert st.X.rot.device.type == "cpu"
    if st.X.n >= FAST_PATH_MIN_POSES:
        assert calls, "the tiled rtr_fast branch did not run"
        assert layouts == ["spmm_strips_plain"] * len(calls)
    else:
        assert not calls
    ms = read_g2o_file(path).pose_pose_measurements
    rep = verify_solution(ms, st.X, 3, eta=1e-3)
    assert rep["certified_indep"] is True


def test_slice_paired_pack_matches_reference(reference, monkeypatch):
    """The 512-pose grid under DCORA_SPMM_PACK=paired: every tile product
    of rtr_fast and the tiled Lanczos goes through spmm_paired on the
    compacted paired packs, and the solve certifies at the reference's rank
    and f*."""
    path, ref = reference("grid8")
    monkeypatch.setenv("DCORA_SPMM_PACK", "paired")
    kinds = []

    def counted(name, real):
        def call(*args):
            kinds.append(name)
            return real(*args)
        return call

    monkeypatch.setattr(ttiled, "spmm_paired",
                        counted("paired", spmm.spmm_paired))
    monkeypatch.setattr(ttiled, "spmm_sym", counted("csr", spmm.spmm_sym))
    layouts = []
    f, st, calls = _port(path, monkeypatch, layouts)
    assert ref["certified"] and st.certified
    assert st.final_rank == ref["rank"]
    np.testing.assert_allclose(f, ref["f"], rtol=1e-8)
    np.testing.assert_allclose(st.f_final, ref["f_lifted"], rtol=1e-8)
    assert calls and "paired" in kinds and "csr" not in kinds
    assert len(kinds) == len(calls)
    assert layouts == ["spmm_paired_plain"] * len(calls)
    rep = verify_solution(read_g2o_file(path).pose_pose_measurements, st.X,
                          3, eta=1e-3)
    assert rep["certified_indep"] is True


def test_recorded_reference_small_grid(tmp_path, monkeypatch):
    """The fixture chip_smoke.py checks against: the port reproduces its
    smallGrid3D entry, regenerated from the recorded generator call."""
    with open(REFERENCE_JSON) as fh:
        refs = json.load(fh)
    assert {"smallGrid3D", "grid10k"} <= set(refs)
    rec = refs["smallGrid3D"]
    kw = dict(rec["kwargs"], shape=tuple(rec["kwargs"]["shape"]))
    path = str(tmp_path / "small.g2o")
    getattr(jds, rec["generator"])(path, **kw)
    f, st, _ = _port(path, monkeypatch)
    assert st.certified and rec["certified"] and rec["ldl_witness"]
    assert st.final_rank == rec["rank"]
    np.testing.assert_allclose(f, rec["f"], rtol=1e-8)
