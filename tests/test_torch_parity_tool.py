"""tools/parity.py of the PyTorch port against the JAX package's: the same
CONFIGS table; run_config on the generated tinyGrid3D and
range_aided_slam_test_3d sets on the CPU against the JAX tool's records on
the same files (tests/data/torch_port_tools_reference.json: the same
certified rank, f_final to 1e-8 and the independent verifier's verdict);
--reverify's round trip; a missing dataset; and artifacts/torch/PARITY.md
byte-identical to what --summary makes of artifacts/torch/parity/*.json
(as tests/test_baseline_captured.py holds BASELINE_CAPTURED.md)."""

import json
import os
import sys

import pytest
import torch

import dcora_tpu.datasets as jds
from dcora_tpu_torch.tools import parity as tparity
from make_torch_port_reference import CASES, OUT_TOOLS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's solver loops issue tiny ops, which a thread pool beside
    the other test workers slows down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.join(os.path.dirname(__file__), os.pardir)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return jds.ensure_test_datasets(str(tmp_path_factory.mktemp("data")))


@pytest.fixture(scope="module")
def refs():
    with open(OUT_TOOLS) as fh:
        return json.load(fh)


def _close(a, b, tol=1e-8):
    return abs(a - b) <= tol * max(1.0, abs(b))


def test_configs_are_the_jax_tools():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import parity as jparity

    assert tparity.CONFIGS == jparity.CONFIGS


@pytest.mark.parametrize("name", ["tinyGrid3D", "ra_slam_test_3d"])
def test_run_config_matches_jax(data, refs, tmp_path, name):
    ref = refs[f"parity_{name}"]
    gen, kw = CASES[f"parity_{name}"]
    assert (ref["generator"], ref["kwargs"]) == (gen, kw)
    rec = tparity.run_config(name, data, "cpu", state_dir=str(tmp_path),
                             checkpoint_dir=str(tmp_path))
    assert rec["platform"] == "cpu" and rec["cfg"] == ref["cfg"]
    for key in ("certified", "final_rank", "certified_indep",
                "psd_proof_indep"):
        assert rec[key] == ref[key], key
    assert rec["certified"] and rec["certified_indep"]
    assert _close(rec["f_final"], ref["f_final"])
    assert _close(rec["f_indep"], ref["f_indep"])
    assert _close(rec["f_rounded"], ref["f_rounded"])
    assert abs(rec["ate_vs_gt"] - ref["ate_vs_gt"]) <= 1e-6
    assert rec["manifold_err"] < 1e-10
    assert os.path.exists(tmp_path / f"{name}.npz")


def test_reverify_round_trip(data, tmp_path, monkeypatch):
    """main --configs writes the record and the state; --reverify re-runs
    only the verifier on the saved state and rewrites its fields."""
    art = tmp_path / "parity"
    monkeypatch.setattr(tparity, "ART", str(art))
    monkeypatch.setattr(tparity, "STATE_DIR", str(art / "state"))
    tparity.main(["--configs", "tinyGrid3D", "--device", "cpu",
                  "--data-dir", data])
    path = art / "tinyGrid3D.json"
    first = json.loads(path.read_text())
    spoiled = dict(first, f_indep=-1.0, certified_indep=None)
    path.write_text(json.dumps(spoiled))
    tparity.main(["--reverify", "--configs", "tinyGrid3D", "--data-dir",
                  data])
    again = json.loads(path.read_text())
    assert "reverified_timestamp" in again
    assert again["certified_indep"] is first["certified_indep"] is True
    assert again["f_indep"] == first["f_indep"]
    assert again["f_final"] == first["f_final"]  # the solve is not re-run


def test_missing_file_raises_naming_it(tmp_path):
    with pytest.raises(FileNotFoundError, match="sphere2500.g2o"):
        tparity.run_config("sphere2500", str(tmp_path), "cpu")


def test_summary_written_by_main(tmp_path, monkeypatch):
    art = tmp_path / "parity"
    art.mkdir()
    (art / "x.json").write_text(json.dumps(dict(
        platform="cpu", certified=True, certified_indep=True,
        psd_proof_indep=True, final_rank=5, f_final=1.5, f_indep=1.5,
        gradnorm_indep=1e-6, min_eig_indep=-1e-9, elapsed_s=2.0)))
    monkeypatch.setattr(tparity, "ART", str(art))
    monkeypatch.setattr(tparity, "SUMMARY", str(tmp_path / "PARITY.md"))
    tparity.main(["--summary"])
    text = (tmp_path / "PARITY.md").read_text()
    assert text == tparity.summary_text(str(art))
    assert "| x | cpu | True | True | True | 5 | 1.500000 |" in text


def test_parity_md_matches_artifacts():
    """--summary is the only writer of artifacts/torch/PARITY.md: the
    committed file regenerates byte for byte from the committed records."""
    with open(tparity.SUMMARY) as fh:
        committed = fh.read()
    assert committed == tparity.summary_text(), (
        "artifacts/torch/PARITY.md is stale against "
        "artifacts/torch/parity/*.json: regenerate with "
        "python -m dcora_tpu_torch.tools.parity --summary")
    assert any(f.endswith(".json") for f in os.listdir(tparity.ART))
