"""Certification's Lanczos as a captured CUDA graph (core/certify.py,
LanczosGraph) on the card, against the eager loop (_lanczos) on the card.

  * For the f64 flat operator (apply_S) and the f32 tiled operator
    (kernel 1 and flat_rhess) at a certified critical point of a small
    grid, unshifted and shifted: two graphed sweeps give the eager loop's
    alphas, betas and basis bit for bit, from one capture.
  * minimum_eigen_pair and minimum_eigen_pair_tiled give the same lambda,
    the same vector and the same number of Lanczos steps through both
    paths, at the critical point and at a random (saddle) state.
  * A rank-deficient operator breaks the Krylov space down at every step
    past the second: the graph draws the eager loop's fresh directions
    from one seeded generator, and leaves the generator where the eager
    loop leaves it (the capture's warm-up spends no draw).
  * Over a certified solve on the card every Lanczos step is a graph
    replay (counters "lanczos.graph_steps" == "lanczos.steps").

Imports only torch, numpy and the port, so it runs where JAX is not
installed; every test skips without a CUDA device.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_certify_cuda.py
"""

from functools import partial

import numpy as np
import pytest
import torch

from dcora_tpu_torch import datasets
from dcora_tpu_torch.core import certify, tiled
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.drivers import single_robot_pgo
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.utils import timing
from test_torch_ldlt import _random_state

pytestmark = pytest.mark.cuda

OPERATORS = ("flat_f64", "tiled_f32")


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A certified solve of a 125-pose grid on the card (its counters), the
    problem at the certified rank, and a random rank-d state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = datasets.generate_grid_g2o(
        str(tmp_path_factory.mktemp("lanczos") / "grid.g2o"),
        shape=(5, 5, 5), rot_noise=0.05, trans_noise=0.02, seed=12)
    timing.reset_counters()
    res = {}
    single_robot_pgo.run(path, certify=True, device="cuda", verbose=False,
                         result=res)
    counts = timing.counters()
    st = res["staircase"]
    g = LocalGraph(0, st.X.r, 3)
    g.set_measurements(read_g2o_file(path).pose_pose_measurements)
    saddle = _random_state(g.dims, 4)
    return dict(P=g.problem_data(device="cuda"), dims=g.dims,
                critical=st.X, certified=st.certified, counts=counts,
                saddle=type(saddle)(*(a.cuda() for a in saddle)))


def _operator(case, op):
    """(make_mv, v0, breakdown) of the operator `op` at the critical point,
    as minimum_eigen_pair(_tiled) builds them."""
    P, X = case["P"], case["critical"]
    if op == "flat_f64":
        C = certify.dual_certificate_blocks(P, X)
        v0 = np.random.default_rng(0).standard_normal(case["dims"].k)
        return (partial(certify._flat_matvec, P, C, case["dims"]),
                torch.as_tensor(v0, device="cuda"), 1e-12)
    TP = _tiled(case)
    Xf = tiled.to_flat(TP, X, r_pad=max(8, -(-X.r // 8) * 8))
    Xf = Xf.to(torch.float32)
    aux = tiled.weingarten_setup(TP.meta, Xf, tiled.apply_tiled(TP, Xf))
    v0 = np.zeros(TP.meta.kpad)
    v0[:TP.meta.k] = np.random.default_rng(0).standard_normal(TP.meta.k)
    return (partial(certify._tiled_matvec, TP, aux),
            torch.as_tensor(v0, dtype=torch.float32, device="cuda"), 1e-7)


def _tiled(case):
    if "TP" not in case:
        case["TP"] = tiled.build_tiled(case["P"], case["dims"],
                                       dtype=torch.float32, device="cuda")
    return case["TP"]


def _eager_sweeps(make_mv, v0, m, breakdown, generator):
    return lambda v, shift: certify._lanczos(make_mv(shift), v, m,
                                             breakdown, generator)


def test_certified_solve_replays_every_step(case):
    c = case["counts"]
    assert case["certified"]
    assert c["lanczos.steps"] > 0
    assert c["lanczos.graph_steps"] == c["lanczos.steps"]
    assert c["certify.calls"] <= c["lanczos.graph_captures"] \
        <= 2 * c["certify.calls"]


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("op", OPERATORS)
def test_graphed_sweeps_match_eager_bitwise(case, op, shifted):
    """Two sweeps from one capture: the eager loop's bits each time, the
    second from where the first left the generator."""
    make_mv, v0, breakdown = _operator(case, op)
    if not shifted:
        shift = 0.0 if op == "flat_f64" else torch.zeros(
            (), dtype=v0.dtype, device="cuda")
    else:
        shift = torch.tensor(-3.25, dtype=v0.dtype, device="cuda")
    m = 64
    gen_e = torch.Generator(device="cuda").manual_seed(1)
    gen_g = torch.Generator(device="cuda").manual_seed(1)
    sweep = certify.LanczosGraph(make_mv, v0, m, breakdown, gen_g)
    timing.reset_counters()
    v_e = v_g = v0
    for _ in range(2):
        want = certify._lanczos(make_mv(shift), v_e, m, breakdown, gen_e)
        got = [a.clone() for a in sweep(v_g, shift)]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        v_e, v_g = want[2][-1], got[2][-1]
    c = timing.counters()
    assert c["lanczos.graph_captures"] == 1
    assert c["lanczos.graph_steps"] == 2 * m
    assert torch.equal(gen_g.get_state(), gen_e.get_state())


@pytest.mark.parametrize("which", ["critical", "saddle"])
@pytest.mark.parametrize("op", OPERATORS)
def test_min_eig_same_through_both_paths(case, monkeypatch, op, which):
    P, X = case["P"], case[which]

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        timing.reset_counters()
        if op == "flat_f64":
            C = certify.dual_certificate_blocks(P, X)
            lam, v, _ = certify.minimum_eigen_pair(P, C, case["dims"], 64,
                                                   generator=gen)
        else:
            lam, v = certify.minimum_eigen_pair_tiled(_tiled(case), X, 64,
                                                      generator=gen)
        return lam, v, timing.counters()

    lam_g, v_g, c_g = run()
    monkeypatch.setattr(certify, "_sweeps", _eager_sweeps)
    lam_e, v_e, c_e = run()
    assert lam_g == lam_e
    assert torch.equal(v_g, v_e)
    assert c_g["lanczos.steps"] == c_e["lanczos.steps"]
    assert c_g["lanczos.graph_steps"] == c_g["lanczos.steps"]
    assert c_g["lanczos.graph_captures"] == 1
    assert c_e.get("lanczos.graph_steps", 0) == 0


def test_breakdown_restarts_draw_the_eager_stream():
    """diag(3, 1, 0, ...) from a start in its range: every step past the
    second breaks down and takes a fresh direction from the generator."""
    k, m = 16, 8
    A = torch.diag(torch.tensor([3.0, 1.0] + [0.0] * (k - 2),
                                dtype=torch.float64, device="cuda"))
    v0 = torch.zeros(k, dtype=torch.float64, device="cuda")
    v0[:2] = 1.0

    def make_mv(shift):
        return lambda v: A @ v + shift * v

    bases = []
    for seed in (0, 1):
        gen_e = torch.Generator(device="cuda").manual_seed(seed)
        gen_g = torch.Generator(device="cuda").manual_seed(seed)
        _, betas, want = certify._lanczos(make_mv(0.0), v0, m, 1e-12, gen_e)
        got = certify.LanczosGraph(make_mv, v0, m, 1e-12, gen_g)(v0, 0.0)[2]
        assert (betas[2:] <= 1e-12).all()
        assert torch.equal(got, want)
        assert torch.equal(gen_g.get_state(), gen_e.get_state())
        np.testing.assert_allclose((got @ got.T).cpu().numpy(), np.eye(m),
                                   atol=1e-12)
        bases.append(got.clone())
    assert not torch.equal(bases[0], bases[1])
