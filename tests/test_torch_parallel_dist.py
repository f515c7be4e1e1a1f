"""The parallel RBCD entry points of the port over torch.distributed, on the
CPU (gloo), and their refusal to run without CUDA unless asked for the CPU:

  * the dry run (dcora_tpu_torch.tools.dryrun_multichip) in two gloo
    processes: 4 rounds with a monotone central cost, the two-rank round
    equal to the one-process round to 1e-12 of max|X|, the sharded S
    matvec's all_reduce over the two ranks equal to apply_S, a tiled round
    and an RA round (the counterpart of tests/test_multihost.py, which the
    JAX package marks slow; this one takes ~10 s);
  * the scaling-mode PGO driver in two gloo processes: each rank owns two
    of the four agents, the cost is nan and the gradnorm the reduced block
    gradnorms, as in the JAX driver;
  * every new entry point raises at its default device when CUDA is absent;
  * the new modules import without JAX.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_dry_run():
    proc = subprocess.run(
        [sys.executable, "-m", "dcora_tpu_torch.tools.dryrun_multichip",
         "2", "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "4 parallel RBCD rounds, monotone central cost" in out
    assert "round matches the one-process round (tol 1e-12" in out
    assert "S matvec over 4 edge shards on 2 ranks equals apply_S" in out
    assert "tiled-backend round OK" in out
    assert "RA-SLAM round OK" in out


def test_parallel_pgo_driver_in_two_gloo_ranks(data_dir):
    url = f"tcp://localhost:{_free_port()}"
    cmd = [sys.executable, "-m", "dcora_tpu_torch.drivers.parallel_pgo", "4",
           os.path.join(data_dir, "smallGrid3D.g2o"), "--device", "cpu",
           "--rounds", "3", "--dist-url", url, "--world-size", "2"]
    procs = [subprocess.Popen(cmd + ["--dist-rank", str(r)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
        line = [x for x in out.splitlines() if x.startswith("parallel-RBCD")]
        assert line and "agents=4 rounds=3 cost=nan" in line[0], out


@pytest.mark.parametrize("entry", ["parallel_pgo", "parallel_raslam",
                                   "dryrun", "scaling_bench"])
def test_entry_points_refuse_without_cuda(entry, data_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.drivers import parallel_pgo, parallel_raslam
    from dcora_tpu_torch.tools import dryrun_multichip, scaling_bench

    g2o = os.path.join(data_dir, "tinyGrid3D.g2o")
    pyfg = datasets.generate_ra_slam_pyfg(str(tmp_path / "ra.pyfg"),
                                          num_landmarks=0)
    calls = dict(
        parallel_pgo=lambda: parallel_pgo.run(2, g2o, max_rounds=1),
        parallel_raslam=lambda: parallel_raslam.run(pyfg, max_rounds=1),
        dryrun=lambda: dryrun_multichip.dryrun(1),
        scaling_bench=lambda: scaling_bench.main())
    argv = sys.argv
    sys.argv = ["scaling_bench", g2o, "--agents", "1"]
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            calls[entry]()
    finally:
        sys.argv = argv


def test_parallel_modules_import_without_jax():
    code = (
        "import sys\n"
        "import dcora_tpu_torch.parallel.rbcd, dcora_tpu_torch.parallel."
        "certify, dcora_tpu_torch.drivers.parallel_pgo, dcora_tpu_torch."
        "drivers.parallel_raslam, dcora_tpu_torch.tools.dryrun_multichip, "
        "dcora_tpu_torch.tools.scaling_bench\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'dcora_tpu.')) or m == 'dcora_tpu']\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr
