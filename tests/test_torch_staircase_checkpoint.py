"""The staircase checkpoint of the PyTorch port is the JAX package's NPZ
(utils/checkpoint.py): a checkpoint the JAX staircase wrote resumes in the
port's staircase, and one the port's wrote resumes in the JAX package's,
each at the written rank and state (1e-12), and the resumed solve
certifies at the JAX package's f* (1e-8).  The generated tinyGrid3D set
(8 poses) solves on the edge path of both engines, whose first solver call
after a resume receives the checkpointed state."""

import numpy as np
import pytest
import torch

import dcora_tpu.core.graph as jgraph
import dcora_tpu.core.init as jinit
import dcora_tpu.core.lifted as jlifted
import dcora_tpu.datasets as jds
import dcora_tpu.io as jio
import dcora_tpu.staircase as jstair
import dcora_tpu.utils.checkpoint as jckpt
import dcora_tpu_torch.staircase as tstair
from dcora_tpu_torch.core import lifted as tlifted
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import chordal_initialization
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_common import np_of


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's solver loops issue tiny ops, which a thread pool beside
    the other test workers slows down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


R_MIN, R_MAX, ETA = 5, 10, 1e-3


@pytest.fixture(scope="module")
def g2o(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tinyGrid3D.g2o")
    jds.generate_grid_g2o(path, **jds._TEST_SETS["tinyGrid3D.g2o"])
    return path


def _jax(path, ckpt):
    ms = jio.read_g2o_file(path).pose_pose_measurements
    g = jgraph.LocalGraph(0, R_MIN, 3)
    g.set_measurements(ms)
    X0 = jlifted.pad_rank(jlifted.from_pose_array(
        jinit.chordal_initialization(ms)), R_MIN)
    return jstair.riemannian_staircase(g, X0, R_MIN, R_MAX,
                                       min_eig_num_tol=ETA,
                                       checkpoint_path=ckpt)


def _port(path, ckpt):
    ms = read_g2o_file(path).pose_pose_measurements
    g = LocalGraph(0, R_MIN, 3)
    g.set_measurements(ms)
    X0 = tlifted.pad_rank(tlifted.from_pose_array(
        chordal_initialization(ms, device="cpu")), R_MIN)
    return tstair.riemannian_staircase(g, X0, R_MIN, R_MAX,
                                       min_eig_num_tol=ETA,
                                       checkpoint_path=ckpt)


def _first_solver_input(monkeypatch, module):
    """Record the state each call of `module`'s rtr starts from."""
    seen, real = [], module.rtr

    def recording(P, G, M, X0, cfg, *a, **kw):
        seen.append(tuple(np_of(x).copy() for x in X0))
        return real(P, G, M, X0, cfg, *a, **kw)

    monkeypatch.setattr(module, "rtr", recording)
    return seen


def _assert_state(got, want, rtol=1e-12):
    scale = max(float(np.abs(w).max(initial=0)) for w in want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max(initial=0)) <= rtol * scale


def test_jax_checkpoint_resumes_in_the_port(g2o, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "jax.npz")
    ref = _jax(g2o, ckpt)
    with np.load(ckpt) as z:
        written = tuple(z[k].copy() for k in ("rot", "sph", "trn"))
        rank = int(z["rank"])
    assert rank == ref.final_rank
    _assert_state(written, tuple(np.asarray(x) for x in ref.X))
    X, r, _, _ = load_checkpoint(ckpt)
    assert r == rank and X.r == rank and X.rot.dtype == torch.float64
    seen = _first_solver_input(monkeypatch, tstair)
    res = _port(g2o, ckpt)
    _assert_state(seen[0], written)
    assert res.certified and res.final_rank == ref.final_rank
    np.testing.assert_allclose(res.f_final, ref.f_final, rtol=1e-8)


def test_port_checkpoint_resumes_in_jax(g2o, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "port.npz")
    res = _port(g2o, ckpt)
    X, r, _, _ = jckpt.load_checkpoint(ckpt)
    assert r == res.final_rank
    written = tuple(np.asarray(x) for x in X)
    _assert_state(written, tuple(np_of(x) for x in res.X), rtol=0.0)
    seen = _first_solver_input(monkeypatch, jstair)
    ref = _jax(g2o, ckpt)
    _assert_state(seen[0], written)
    assert ref.certified and ref.final_rank == res.final_rank
    np.testing.assert_allclose(ref.f_final, res.f_final, rtol=1e-8)


def test_checkpoint_file_is_the_npz_format(g2o, tmp_path):
    """The port writes np.savez's NPZ with the JAX keys, never a torch
    pickle: numpy alone reads it."""
    ckpt = str(tmp_path / "port.npz")
    res = _port(g2o, ckpt)
    with np.load(ckpt, allow_pickle=False) as z:
        assert sorted(z.files) == ["rank", "rot", "sph", "trn"]
        assert int(z["rank"]) == res.final_rank
        assert z["rot"].shape == (8, res.final_rank, 3)
