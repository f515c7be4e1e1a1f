"""tools/g2o100k_certify.py of the PyTorch port on a small grid of the
same generator (generate_large_scale_g2o at target_poses=512: an 8^3 grid,
at FAST_PATH_MIN_POSES, so the tiled phases run), on the CPU, against the
same steps through the JAX package's functions (its tool's body, recorded
in tests/data/torch_port_tools_reference.json): the same rank, f_final
(1e-8), S's non-zeros, LDL^T verdict, host min-eig verdict and
independent certificate; and the record's fields and resume."""

import json
import os

import numpy as np
import pytest
import torch

import dcora_tpu.datasets as jds
from dcora_tpu_torch import datasets as tds
from dcora_tpu_torch.tools import g2o100k_certify as tool
from make_torch_port_reference import OUT_TOOLS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's solver loops issue tiny ops, which a thread pool beside
    the other test workers slows down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RMIN, RMAX, TCG, ETA = 5, 8, 50, 1e-3


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    d = tmp_path_factory.mktemp("g2o100k")
    path = tds.generate_large_scale_g2o(str(d / "g512.g2o"),
                                        target_poses=512)
    return d, path


def test_the_generator_is_the_jax_packages(grid):
    """The recorded reference's file: the port's generator writes the JAX
    package's bytes."""
    d, path = grid
    other = jds.generate_large_scale_g2o(str(d / "jax512.g2o"),
                                         target_poses=512)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def jax_record():
    """The JAX tool's steps on the same file, recorded by
    tests/make_torch_port_reference.py (tool_g2o512: ~45 s on a CPU)."""
    with open(OUT_TOOLS) as fh:
        rec = json.load(fh)["tool_g2o512"]
    assert rec["generator"] == "generate_large_scale_g2o"
    assert rec["kwargs"] == {"target_poses": 512}
    assert rec["params"] == dict(rmin=RMIN, rmax=RMAX, tcg=TCG, eta=ETA)
    return rec


@pytest.fixture(scope="module")
def port_record(grid):
    d, path = grid
    out = str(d / "record.json")
    rec = tool.run(path, RMIN, RMAX, TCG, ETA, device="cpu",
                   checkpoint_path=str(d / "ckpt.npz"), out=out,
                   state_path=str(d / "state.npz"))
    return rec, out


def test_matches_the_jax_steps(port_record, jax_record):
    rec, _ = port_record
    for key in ("certified", "final_rank", "k", "S_nnz", "ldl_proof",
                "min_eig_host_certified", "certified_indep",
                "psd_proof_indep"):
        assert rec[key] == jax_record[key], key
    np.testing.assert_allclose(rec["f_final"], jax_record["f_final"],
                               rtol=1e-8)
    np.testing.assert_allclose(rec["f_indep"], jax_record["f_indep"],
                               rtol=1e-8)
    assert rec["n_poses"] == 512 and rec["k"] == 4 * 512


def test_record_fields(port_record):
    """Every timing field of the JAX tool's record, and the port's own."""
    rec, out = port_record
    with open(out) as fh:
        assert json.load(fh) == json.loads(json.dumps(rec, default=str))
    for key in ("t_parse_s", "t_chordal_init_s", "t_solve_s",
                "t_lambda_device_s", "t_S_assemble_s", "t_ldl_proof_s",
                "t_min_eig_host_s", "t_verify_indep_s", "f_rounded",
                "min_eig_host_theta", "gradnorm_indep", "min_eig_indep",
                "manifold_err", "timestamp"):
        assert key in rec, key
    assert rec["in_progress"] is False and rec["step"] == "done"
    assert rec["platform"] == "cpu" and rec["reader"] == "native"
    assert len(rec["chordal_cg_iters"]) == 2
    # the plain versions here: no kernel launches
    assert rec["launches"] == {"spmm_sym": 0, "spmm_symmetric": 0,
                               "spmm_paired": 0, "segment_sum": 0}
    assert rec["rss_peak_ldl_gb"] > 0 and rec["elapsed_s"] > 0


def test_state_and_resume(grid, port_record):
    """The final state is saved; a second run resumes from the checkpoint
    at the final rank and reaches the same result."""
    d, path = grid
    rec, _ = port_record
    with np.load(str(d / "state.npz")) as z:
        assert z["rot"].shape == (512, rec["final_rank"], 3)
    with np.load(str(d / "ckpt.npz")) as z:
        assert int(z["rank"]) == rec["final_rank"]
    again = tool.run(path, RMIN, RMAX, TCG, ETA, device="cpu",
                     checkpoint_path=str(d / "ckpt.npz"))
    assert again["final_rank"] == rec["final_rank"]
    assert again["certified"] == rec["certified"]
    np.testing.assert_allclose(again["f_final"], rec["f_final"], rtol=1e-8)
    assert any("resuming" in line for line in again["log"]) or \
        again["log"] == []  # INFO lines reach the record when enabled


def test_cli_defaults(monkeypatch, tmp_path):
    """The CLI adds the JAX tool's default paths: the generated file in
    the dcora_tpu cache, the checkpoint in the temporary directory, the
    record under artifacts/torch/."""
    seen = {}
    monkeypatch.setattr(tool, "run", lambda *a, **kw: seen.update(
        args=a, kw=kw) or {})
    monkeypatch.setattr(tool, "CACHE", str(tmp_path))
    (tmp_path / "g2o100k.g2o").write_text("")
    tool.main(["--device", "cpu"])
    assert seen["args"][0] == os.path.join(str(tmp_path), "g2o100k.g2o")
    assert seen["args"][1:] == (5, 8, 50, 1e-3, "cpu")
    assert seen["kw"]["out"].endswith(os.path.join(
        "artifacts", "torch", "g2o100k_certify.json"))
    assert seen["kw"]["checkpoint_path"].endswith("dcora_ckpt_g2o100k.npz")
    assert seen["kw"]["state_path"].endswith(os.path.join(
        "artifacts", "torch", "state", "g2o100k.npz"))
