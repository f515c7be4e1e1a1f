"""The certificate's supernodal LDL^T kernel (csrc/ldlt.cu) on the card.

  * Its pivots against the plain factorization's (core/ldlt.factor_plain,
    on the CPU, the same analysis): within 1e-9 of max|pivot| (f64; the
    kernel sums the panel solve and the rank-32 updates in another order,
    on the tensor cores), and the same negative count, on S of a small grid
    PGO, a 6^3 grid and a small range-aided problem, at shifts where S + tI
    is positive definite, indefinite, and at the inertia bracket's ends.
  * On SE-Sync's grid3D pattern (the benchmark's 20^3 graph, k = 32,000),
    Q + eta I is proven positive definite and Q - eta I (a shift below
    lambda_min(Q) = 0) indefinite; the pivots within 1e-9 of the plain
    factorization's.
  * Two factorizations give the same bits; a CSR S that stores an entry
    twice is factored as its sum.
  * A CUDA problem's _min_eig_host proves on the card: the kernel's launch
    count and the counter "ldlt.device" move, "ldlt.host" stays 0, one
    analysis per call; the verdicts are SuperLU's.

Imports only torch, numpy, scipy and the port, so it runs where JAX is not
installed; every test skips without a CUDA device.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_ldlt_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dcora_tpu_torch import datasets
from dcora_tpu_torch.core import certify, kernels, ldlt, lifted
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.utils import timing
from test_torch_ldlt import (PROBLEMS, SHIFTS, _random_state, _shift,
                             build_cases, doubled_entries)

pytestmark = pytest.mark.cuda

RTOL = 1e-9
ETA = 1e-3


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return build_cases(tmp_path_factory.mktemp("ldlt"))


def _grid(path, shape, **kw):
    datasets.generate_grid_g2o(path, shape=shape, **kw)
    g = LocalGraph(0, 3, 3)
    g.set_measurements(read_g2o_file(path).pose_pose_measurements)
    return g


def _device_pivots(an, S, t):
    plan = ldlt.DeviceFactor(an, "cuda")
    vals = torch.as_tensor(S.data, device="cuda")
    return plan.factor(vals, t).clone()


@pytest.mark.parametrize("kind", SHIFTS)
@pytest.mark.parametrize("name", PROBLEMS)
def test_kernel_pivots_match_plain(cases, name, kind):
    c = cases[name]
    an, S, t = c["an"], c["S"], _shift(c, kind)
    want = ldlt.factor_plain(an, torch.as_tensor(S.data), t)
    got = _device_pivots(an, S, t).cpu()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= RTOL, err
    assert int((got < 0).sum()) == int((want < 0).sum())
    assert ldlt.verdict(got) == certify.ldl_psd_proof(
        S + t * sp.identity(S.shape[0]))


def test_grid3d_pattern_verdicts_and_pivots(tmp_path):
    g = _grid(str(tmp_path / "grid3d.g2o"), (20, 20, 20), loop_prob=0.962,
              seed=199)
    Q = certify._Q_host(g.problem_data(), g.dims)
    assert Q.shape[0] == 32_000
    proof = ldlt.ShiftedProof(Q, g.dims, "cuda")
    assert proof(ETA) is True
    assert proof(-ETA) is False
    got = proof.pivots(ETA).cpu()
    want = ldlt.factor_plain(proof.plan.an, torch.as_tensor(Q.data), ETA)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= RTOL, err


def test_shifted_proof_sums_duplicate_entries(cases):
    c = cases["grid"]
    dup = doubled_entries(c["S"])
    t = _shift(c, "one_negative")
    got = ldlt.ShiftedProof(dup, c["dims"], "cuda").pivots(t).cpu()
    want = ldlt.factor_plain(c["an"], torch.as_tensor(c["S"].data), t)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= RTOL, err


@pytest.mark.parametrize("name", PROBLEMS)
def test_two_factorizations_are_bitwise_equal(cases, name):
    c = cases[name]
    plan = ldlt.DeviceFactor(c["an"], "cuda")
    vals = torch.as_tensor(c["S"].data, device="cuda")
    t = _shift(c, "one_negative")
    a = plan.factor(vals, t).clone()
    plan.fronts.fill_(float("nan"))  # nothing may be read before written
    b = plan.factor(vals, t).clone()
    assert torch.equal(a, b)


def test_min_eig_host_proves_on_the_card(tmp_path):
    g = _grid(str(tmp_path / "g.g2o"), (4, 4, 3), seed=5)
    P, dims = g.problem_data(device="cuda"), g.dims
    X = lifted.RAState(*(a.to("cuda") for a in _random_state(dims, 3)))
    C = certify.dual_certificate_blocks(P, X)
    timing.reset_counters()
    before = kernels.launch_counts()["ldlt"]
    times = {}
    ok, theta, _ = certify._min_eig_host(P, C, dims, 1e-4, times=times)
    counts = timing.counters()
    S = certify._assemble_S_host(P, C, dims)
    lam = np.linalg.eigvalsh(S.toarray())[0]
    assert not ok and theta < -1e-4 and lam < -1e-4
    assert counts.get("ldlt.host", 0) == 0
    assert counts["ldlt.analyses"] == 1
    assert counts["ldlt.device"] >= 2  # the proof, then the bracket
    an = ldlt.analyse(S, dims)
    assert kernels.launch_counts()["ldlt"] - before == \
        counts["ldlt.device"] * len(an.launches)
    assert times["certify/ldlt_analyse"] <= times["certify/ldlt"]
    # with eta past -lambda_min the first proof certifies
    timing.reset_counters()
    ok, _, _ = certify._min_eig_host(P, C, dims, 1e-3 - lam)
    assert ok
    assert timing.counters().get("ldlt.device") == 1
    assert timing.counters().get("ldlt.host", 0) == 0
