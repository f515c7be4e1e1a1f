"""Certification of the PyTorch port vs the JAX package: the dual
certificate, edge and tiled Lanczos from the same start vector, the
fast_verification verdict, the saddle escape and the rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcora_tpu.core.certify as jcert
import dcora_tpu.core.lifted as jlifted
import dcora_tpu.core.problem as jprob
import dcora_tpu.core.rtr as jrtr
import dcora_tpu.core.tiled as jtiled
import dcora_tpu.datasets as jds
import dcora_tpu.io as jio
import dcora_tpu_torch.core.certify as tcert
import dcora_tpu_torch.core.lifted as tlifted
import dcora_tpu_torch.core.problem as tprob
import dcora_tpu_torch.core.tiled as ttiled
from dcora_tpu.core.graph import LocalGraph
from dcora_tpu.core.init import chordal_initialization
from dcora_tpu_torch import convert
from dcora_tpu_torch.utils import timing
from torch_port_common import assert_close, assert_state_close, np_of


@pytest.fixture(scope="module")
def critical(tmp_path_factory):
    """A rank-5 critical point of a small generated grid (JAX solve), and a
    rank-3 (d) start that is not critical."""
    path = str(tmp_path_factory.mktemp("c") / "g.g2o")
    jds.generate_grid_g2o(path, shape=(3, 3, 2), rot_noise=0.1,
                          trans_noise=0.05, seed=3)
    ms = jio.read_g2o_file(path).pose_pose_measurements
    g = LocalGraph(0, 5, 3)
    g.set_measurements(ms)
    Pj = g.problem_data()
    Mj = jprob.build_preconditioner_host(Pj, g.n, 0, 0, 3, 0.1)
    T = chordal_initialization(ms)
    X3 = jlifted.from_pose_array(T)
    X0 = jlifted.pad_rank(X3, 5)
    cfg = jrtr.RTRConfig(gradnorm_tol=1e-10, max_outer=100, max_inner=100)
    X = jrtr.rtr(Pj, jlifted.zeros(g.dims, 5), Mj, X0, cfg).X
    return dict(g=g, Pj=Pj, Pt=convert.problem_data(Pj), Mj=Mj,
                Xj=X, Xt=convert.ra_state(X), X3j=X3,
                X3t=convert.ra_state(X3))


def test_certificate_blocks_and_apply_S(critical):
    Cj = jcert.dual_certificate_blocks(critical["Pj"], critical["Xj"])
    Ct = tcert.dual_certificate_blocks(critical["Pt"], critical["Xt"])
    for a, b in zip(Ct, Cj):
        assert_close(a, b, rtol=1e-9)
    rng = np.random.default_rng(0)
    V = [rng.standard_normal(np.shape(a)) for a in critical["Xj"]]
    ref = jcert.apply_S(critical["Pj"], Cj, jlifted.RAState(*map(jnp.asarray,
                                                                 V)))
    out = tcert.apply_S(critical["Pt"], Ct,
                        tlifted.RAState(*map(torch.as_tensor, V)))
    assert_state_close(out, ref, rtol=1e-9)


def test_host_Q_matches(critical):
    dims = critical["g"].dims
    Qj = jcert._Q_host(critical["Pj"], dims)
    Qt = tcert._Q_host(critical["Pt"], dims)
    assert abs(Qt - Qj).max() <= 1e-12 * abs(Qj).max()


@pytest.mark.parametrize("which", ["critical", "saddle"])
def test_edge_lanczos_same_v0(critical, which):
    key = "X" if which == "critical" else "X3"
    Xj, Xt = critical[key + "j"], critical[key + "t"]
    dims = Xj.dims
    Cj = jcert.dual_certificate_blocks(critical["Pj"], Xj)
    Ct = tcert.dual_certificate_blocks(critical["Pt"], Xt)
    v0 = np.random.default_rng(5).standard_normal(dims.k)
    lj, _, _ = jcert.minimum_eigen_pair(critical["Pj"], Cj, dims, 64, v0=v0)
    lt, vt, _ = tcert.minimum_eigen_pair(critical["Pt"], Ct, dims, 64, v0=v0)
    np.testing.assert_allclose(lt, lj, rtol=1e-8, atol=1e-9)
    assert vt.shape == (dims.k,)


@pytest.mark.parametrize("which", ["critical", "saddle"])
def test_tiled_lanczos_same_v0(critical, which):
    key = "X" if which == "critical" else "X3"
    g = critical["g"]
    TPj = jtiled.build_tiled(critical["Pj"], g.dims, dtype=np.float64,
                             with_pallas=False)
    TPt = ttiled.build_tiled(critical["Pt"], g.dims, dtype=torch.float64)
    lj, vj = jcert.minimum_eigen_pair_tiled(TPj, critical[key + "j"], 64)
    lt, vt = tcert.minimum_eigen_pair_tiled(TPt, critical[key + "t"], 64)
    np.testing.assert_allclose(lt, lj, rtol=1e-8, atol=1e-9)
    assert_close(abs(np_of(vt)), abs(np.asarray(vj)), rtol=1e-6)


@pytest.mark.parametrize("which", ["critical", "saddle"])
def test_fast_verification_verdict(critical, which):
    key = "X" if which == "critical" else "X3"
    g = critical["g"]
    TPj = jtiled.build_tiled(critical["Pj"], g.dims, dtype=np.float32,
                             with_pallas=False)
    TPt = ttiled.build_tiled(critical["Pt"], g.dims, dtype=torch.float32)
    okj, thj, _ = jcert.fast_verification(critical["Pj"], critical[key + "j"],
                                          1e-3, 64, TP=TPj)
    okt, tht, _ = tcert.fast_verification(critical["Pt"], critical[key + "t"],
                                          1e-3, 64, TP=TPt)
    assert okt == okj
    assert okj == (which == "critical")
    if not okj:
        assert tht < -1e-3 and thj < -1e-3


def test_cpu_lanczos_runs_eager(critical):
    """On the CPU every Lanczos sweep is the eager loop: no graph is
    captured and no step counted as a graph replay, and fast_verification
    gives the JAX package's verdicts (the critical point certified, the
    rank-3 start not)."""
    g = critical["g"]
    TPt = ttiled.build_tiled(critical["Pt"], g.dims, dtype=torch.float32)
    TPj = jtiled.build_tiled(critical["Pj"], g.dims, dtype=np.float32,
                             with_pallas=False)
    timing.reset_counters()
    for key in ("X", "X3"):
        okt, _, _ = tcert.fast_verification(critical["Pt"],
                                            critical[key + "t"], 1e-3, 64,
                                            TP=TPt)
        okj, _, _ = jcert.fast_verification(critical["Pj"],
                                            critical[key + "j"], 1e-3, 64,
                                            TP=TPj)
        assert okt == okj == (key == "X")
    c = timing.counters()
    assert c["certify.calls"] == 2 and c["lanczos.steps"] > 0
    assert c.get("lanczos.graph_steps", 0) == 0
    assert c.get("lanczos.graph_captures", 0) == 0


def test_escape_saddle_matches(critical):
    """From the rank-3 start along the same direction: same verdict and the
    same rank-4 point."""
    Xj, Xt = critical["X3j"], critical["X3t"]
    Pj, Pt = critical["Pj"], critical["Pt"]
    Cj = jcert.dual_certificate_blocks(Pj, Xj)
    theta, v, _ = jcert.minimum_eigen_pair(Pj, Cj, Xj.dims, 64)
    assert theta < 0
    okj, Yj = jcert.escape_saddle(Pj, Xj, theta, v, 4, M=critical["Mj"],
                                  is_second_order=True)
    okt, Yt = tcert.escape_saddle(Pt, Xt, theta, torch.tensor(v), 4,
                                  M=convert.preconditioner(critical["Mj"]),
                                  is_second_order=True)
    assert okt == okj
    assert_state_close(Yt, Yj)


def test_round_solution_matches_up_to_gauge(critical):
    """Rounding agrees up to the global O(d) gauge of the SVD: compare the
    gauge-invariant Gram matrix X^T X and the cost."""
    Rj = jcert.round_solution(critical["Xj"])
    Rt = tcert.round_solution(critical["Xt"])
    Fj = np.asarray(jlifted.to_flat(Rj))
    Ft = np_of(tlifted.to_flat(Rt))
    assert_close(Ft.T @ Ft, Fj.T @ Fj)
    assert_close(tprob.cost(critical["Pt"], Rt),
                 jprob.cost(critical["Pj"], Rj))
    dets = np.linalg.det(np_of(Rt.rot))
    np.testing.assert_allclose(dets, 1.0, atol=1e-12)


def test_lanczos_breakdown_restart_uses_generator():
    """A rank-deficient operator breaks the Krylov space down: the restart
    vectors come from the injected generator, and stay orthonormal."""
    A = torch.diag(torch.tensor([3.0, 1.0, 0.0, 0.0, 0.0, 0.0],
                                dtype=torch.float64))
    v0 = torch.tensor([1.0, 1.0, 0, 0, 0, 0], dtype=torch.float64)
    outs = []
    for seed in (0, 0, 1):
        gen = torch.Generator().manual_seed(seed)
        _, betas, basis = tcert._lanczos(lambda v: A @ v, v0, 5, 1e-12, gen)
        outs.append(basis)
        np.testing.assert_allclose(np_of(basis @ basis.T), np.eye(5),
                                   atol=1e-12)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def _clustered_sweeps(m):
    """sweep(v, shift) of m Lanczos steps on a 40 x 40 symmetric operator
    whose three lowest eigenvalues lie within 2e-7 of -1 and whose largest
    is 100, and the log of its calls: (start, shift, Ritz value, vector)."""
    rng = np.random.default_rng(8)
    Q = np.linalg.qr(rng.standard_normal((40, 40)))[0]
    ev = np.concatenate([[-1.0, -1.0 + 1e-7, -1.0 + 2e-7],
                         np.linspace(0.5, 100.0, 37)])
    A = torch.as_tensor(Q @ np.diag(ev) @ Q.T)
    gen = torch.Generator().manual_seed(0)
    log = []

    def sweep(v, shift):
        out = tcert._lanczos(lambda u: A @ u + shift * u, v, m, 1e-12, gen)
        lam, y, _ = tcert._ritz_extreme(*out)
        log.append((v, shift, lam, y))
        return out

    return sweep, log, torch.as_tensor(rng.standard_normal(40))


@pytest.mark.parametrize("rel_tol, cap, sweeps", [
    (1e-9, 40, None),  # converging on the cluster
    (1.0, 40, 3),      # every restart stagnant: stops after two of them
    (1e-9, 2, 2),      # stopped by the cap
])
def test_spectrum_shift_restart_rule(rel_tol, cap, sweeps):
    """The restart loop of every Lanczos search: after the unshifted sweep
    (lam_lm > 0) the shifted sweeps run from start(), then each from
    the last Ritz vector; the loop stops after two consecutive sweeps that
    gain no more than the tolerance, or at its cap, and keeps the lowest
    estimate and its vector among the sweeps before the one that stops it
    (lam_lm is a 6-step estimate of 100)."""
    sweep, log, v0 = _clustered_sweeps(6)
    start = torch.ones(40, dtype=torch.float64)
    lam, y, _ = tcert._spectrum_shift(sweep, v0, lambda: start, rel_tol,
                                      1e-12, cap)
    (v_first, shift0, lam_lm, _), restarts = log[0], log[1:]
    assert v_first is v0 and shift0 == 0.0
    assert 0 < float(lam_lm) <= 100.0
    assert restarts[0][0] is start
    for (_, _, _, y_prev), (v, shift, _, _) in zip(restarts, restarts[1:]):
        assert torch.equal(v, y_prev)
    assert all(float(shift) == float(-2.0 * lam_lm)
               for _, shift, _, _ in restarts)
    cur = [float(lam_s + 2.0 * lam_lm) for _, _, lam_s, _ in restarts]
    tol = max(1e-12, rel_tol * abs(float(lam_lm)))
    stagnant = [c > min(cur[:i]) - tol for i, c in enumerate(cur) if i]
    if sweeps is not None:
        assert len(cur) == sweeps
    kept = cur
    if len(cur) < cap:  # stopped by two stagnant sweeps, the first pair
        assert stagnant[-2:] == [True, True]
        assert not any(a and b for a, b in zip(stagnant[:-2],
                                                stagnant[1:-1]))
        kept = cur[:-1]  # the sweep that stops the loop is not kept
    else:
        assert len(cur) == cap
    i_min = int(np.argmin(kept))
    assert lam == kept[i_min] and torch.equal(y, restarts[i_min][3])
    if sweeps is None:  # the cluster is approached over several sweeps
        assert 3 < len(cur) < cap and lam == pytest.approx(-1.0, abs=1e-4)


@pytest.mark.parametrize("eta", [0.0, 1e-4])
def test_host_min_eig_repeats_within_a_process(critical, eta):
    """The host path's ARPACK calls start from seeded vectors: the same S
    gives the same estimate and vector on every call of a process (ARPACK's
    own start vector comes from a stream that moves on from call to call).
    eta 0 runs the largest-eigenvalue shift, eta 1e-4 the LDL^T proof and
    the shift-invert inside its inertia bracket, at the non-critical
    rank-3 start."""
    P, X = critical["Pt"], critical["X3t"]
    C = tcert.dual_certificate_blocks(P, X)
    runs = [tcert._min_eig_host(P, C, X.dims, eta) for _ in range(3)]
    assert not runs[0][0] and runs[0][1] < -eta
    for ok, theta, v in runs[1:]:
        assert ok == runs[0][0] and theta == runs[0][1]
        assert np.array_equal(v, runs[0][2])
