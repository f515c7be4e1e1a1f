"""The RA-SLAM slice of the PyTorch port vs the JAX package on a generated
range-aided problem (3 robots x 20 poses, 46 unit spheres, 2 landmarks,
rot / trans / range noise 0.05 / 0.02 / 0.02), read by each package's own
parser: the edge path, the tiled path with the block-tridiagonal (BTD)
preconditioner, and the certification.

Tolerances (relative to the reference's max): f64 operators 1e-10 (the
port's bar, tests/torch_port_common.py); the graph-form BTD recurrences
against the plain loop 1e-12 in f64 and 1e-5 in f32; Lanczos eigenvalues
from the same start vector to 1e-10 of lambda_max(Q) on the edge operator
and 1e-8 on the tiled one: the bottom of S is found by Lanczos on
S - 2 lambda_max I, so its absolute accuracy is set by the top of the
spectrum (~1e6 here), not by the eigenvalue itself (~0 at the critical
point, where neither estimate has converged), and the tiled operator
sums the assembled Q in another order than the JAX package's XLA tile
path.  The critical point is a JAX RTR
solve at rank 3 to gradnorm 1e-9; the saddle is the odometry
initialization, which the certificate rejects.
"""

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
import dcora_tpu.solvers as jsolvers
import dcora_tpu_torch.core.certify as tcert
import dcora_tpu_torch.core.lifted as tlifted
import dcora_tpu_torch.core.problem as tprob
import dcora_tpu_torch.core.tiled as ttiled
import dcora_tpu_torch.solvers as tsolvers
from dcora_tpu.core.graph import LocalGraph as JGraph
from dcora_tpu.drivers.single_robot_raslam import odometry_init_global
from dcora_tpu.io import read_pyfg_file as jread
from dcora_tpu.io.remap import get_global_measurements as jglobal
from dcora_tpu.types import GraphType as JGraphType
from dcora_tpu_torch import convert
from dcora_tpu_torch.core.graph import LocalGraph as TGraph
from dcora_tpu_torch.io import read_pyfg_file as tread
from dcora_tpu_torch.io.remap import get_global_measurements as tglobal
from dcora_tpu_torch.types import GraphType as TGraphType
from torch_port_common import (
    assert_close,
    assert_segments_equal,
    assert_state_close,
    np_of,
)

ETA = 1e-4  # the RA driver's certificate tolerance


@pytest.fixture(scope="module")
def ra(tmp_path_factory):
    path = jds.generate_ra_slam_pyfg(
        str(tmp_path_factory.mktemp("ra") / "ra60.pyfg"), num_robots=3,
        poses_per_robot=20, num_landmarks=2, range_prob=1.0, rot_noise=0.05,
        trans_noise=0.02, range_noise=0.02, seed=3)
    ds = jread(path)
    gj = JGraph(0, 3, 3, JGraphType.RangeAidedSLAMGraph)
    gj.set_measurements(jglobal(ds).relative_measurements)
    gt = TGraph(0, 3, 3, TGraphType.RangeAidedSLAMGraph)
    gt.set_measurements(tglobal(tread(path)).relative_measurements)
    Pj = gj.problem_data()
    Mj = jsolvers.make_preconditioner(gj, Pj)
    X0 = odometry_init_global(ds, jglobal(ds))
    cfg = jrtr.RTRConfig(gradnorm_tol=1e-9, max_outer=300, max_inner=200)
    X = jrtr.rtr(Pj, jlifted.zeros(gj.dims, 3), Mj, X0, cfg).X
    return dict(gj=gj, gt=gt, Pj=Pj, Pt=convert.problem_data(Pj), Mj=Mj,
                Xj=X, Xt=convert.ra_state(X), X0j=X0,
                X0t=convert.ra_state(X0))


def test_ra_graph_dims_and_problem_data(ra):
    """The port's LocalGraph on its own parse of the file == the JAX
    graph's ProblemData carried across (5 robots' global measurements:
    pose-pose, pose-landmark and range edges)."""
    gj, gt = ra["gj"], ra["gt"]
    dims = [(g.dims.d, g.dims.n, g.dims.l, g.dims.b) for g in (gj, gt)]
    assert dims[0] == dims[1] == (3, 60, 46, 2)
    assert not gt.is_pgo_compatible()
    Pg, Pc = gt.problem_data(), ra["Pt"]
    for name in tprob.ProblemData._fields:
        a, b = getattr(Pg, name), getattr(Pc, name)
        if a is None or b is None:
            assert a is None and b is None, name
        elif name == "prior_G":
            for x, y in zip(a, b):
                assert_close(x, y, rtol=1e-12)
        elif name == "seg":
            assert_segments_equal(a, b)
        elif a.dtype.is_floating_point:
            assert_close(a, b, rtol=1e-12)  # native vs numpy parse: ulps
        else:
            assert torch.equal(a, b), name
    assert int(Pc.rg_ti.shape[0]) == 46 and int(Pc.pl_ri.shape[0]) == 2


@pytest.mark.parametrize("op", ["apply_Q", "cost", "egrad", "hessian_vec"])
def test_ra_edge_operators(ra, op):
    Pj, Pt = ra["Pj"], ra["Pt"]
    rng = np.random.default_rng(1)
    V = [rng.standard_normal(np.shape(a)) for a in ra["X0j"]]
    Vj = jlifted.RAState(*map(jnp.asarray, V))
    Vt = tlifted.RAState(*map(torch.as_tensor, V))
    if op == "apply_Q":
        assert_state_close(tprob.apply_Q(Pt, ra["X0t"]),
                           jprob.apply_Q(Pj, ra["X0j"]))
    elif op == "cost":
        assert_close(tprob.cost(Pt, ra["X0t"]), jprob.cost(Pj, ra["X0j"]))
    elif op == "egrad":
        assert_state_close(tprob.euclidean_gradient(Pt, ra["X0t"]),
                           jprob.euclidean_gradient(Pj, ra["X0j"]))
    else:
        assert_state_close(tprob.hessian_vec(Pt, Vt),
                           jprob.hessian_vec(Pj, Vj))


def test_ra_precond_reg_and_preconditioner(ra):
    """The RA rule lambda_max / (1e6 - 1) by power iteration, and the host
    block-Jacobi build with sphere and landmark diagonals."""
    gj, gt = ra["gj"], ra["gt"]
    reg_j = jsolvers.precond_reg(gj, ra["Pj"])
    reg_t = tsolvers.precond_reg(gt, ra["Pt"])
    assert reg_j != 0.1
    np.testing.assert_allclose(reg_t, reg_j, rtol=1e-10)
    Mt = tprob.build_preconditioner_host(ra["Pt"], gt.n, gt.l, gt.b, gt.d,
                                         reg_t)
    for a, b in zip(Mt, ra["Mj"]):  # the JAX build may be native
        assert_close(a, b)
    assert bool((Mt.sph_diag > 0).all()) and bool((Mt.lmk_diag > 0).all())
    assert tsolvers._tile_preconditioner(gt, ra["Pt"]) == "btd"


@pytest.fixture(scope="module")
def tiled_pair(ra):
    """The RA tile builds of both packages, f64, with the BTD factor as
    rtr_fast builds them (reg from precond_reg, the host block-Jacobi)."""
    gj, Pj = ra["gj"], ra["Pj"]
    reg = jsolvers.precond_reg(gj, Pj)
    TPj = jtiled.build_tiled(Pj, gj.dims, dtype=np.float64, precond=ra["Mj"],
                             reg=reg, tile_precond="btd", with_pallas=False)
    TPt = ttiled.build_tiled(ra["Pt"], gj.dims, dtype=torch.float64,
                             precond=convert.preconditioner(ra["Mj"]),
                             reg=reg, tile_precond="btd")
    return TPj, TPt


def test_ra_build_tiled_fields(tiled_pair):
    TPj, TPt = tiled_pair
    m = TPt.meta
    assert (m.n, m.l, m.b, m.nt) == (60, 46, 2, 3) and m.nt == TPj.meta.nt
    np.testing.assert_array_equal(np_of(TPt.Q.ra_of_fl), TPj.Q.ra_of_fl)
    np.testing.assert_array_equal(np_of(TPt.Q.fl_of_ra), TPj.Q.fl_of_ra)
    # spheres after the poses, landmarks after the spheres (flat order)
    fl = np_of(TPt.Q.fl_of_ra)
    assert set(fl[3 * m.n:3 * m.n + m.l]) == set(range(m.pose_end,
                                                       m.sph_end))
    assert set(fl[-m.b:]) == set(range(m.sph_end, m.sph_end + m.b))
    for name in ("sph_inv", "lmk_inv", "btd_ltil", "btd_sinv"):
        assert_close(getattr(TPt, name), getattr(TPj, name))
    assert TPt.diag_inv is None and TPj.diag_inv is None
    assert_close(TPt.pose_inv, np.asarray(TPj.pose_inv).transpose(2, 0, 1))


@pytest.mark.parametrize("r_pad", [8, 16])
def test_ra_flat_ops_and_btd(tiled_pair, ra, r_pad):
    """precondition_flat (the BTD solve), the tile product through the
    strip layout, and the sphere parts of the flat manifold ops."""
    TPj, TPt = tiled_pair
    rng = np.random.default_rng(r_pad)
    Xj = jtiled.to_flat(TPj, ra["Xj"], r_pad=r_pad)
    Xt = ttiled.to_flat(TPt, ra["Xt"], r_pad=r_pad)
    assert_close(Xt, Xj, rtol=0)
    V = rng.standard_normal(Xt.shape)
    V[3:] = 0.0
    Vj, Vt = jnp.asarray(V), torch.as_tensor(V)
    assert_close(ttiled.precondition_flat(TPt, Vt),
                 jtiled.precondition_flat(TPj, Vj))
    assert_close(ttiled.apply_tiled(TPt, Xt), jtiled.apply_tiled(TPj, Xj),
                 rtol=1e-12)
    Tj = jtiled.tangent_project_flat(TPj.meta, Xj, Vj)
    Tt = ttiled.tangent_project_flat(TPt.meta, Xt, Vt)
    assert_close(Tt, Tj)
    Gj, Gt = jtiled.egrad_flat(TPj, Xj), ttiled.egrad_flat(TPt, Xt)
    assert_close(ttiled.weingarten_apply(
                     TPt.meta, Tt, ttiled.weingarten_setup(TPt.meta, Xt,
                                                           Gt)),
                 jtiled.weingarten_apply(
                     TPj.meta, Tj, jtiled.weingarten_setup(TPj.meta, Xj,
                                                           Gj)))
    assert_close(ttiled.retract_flat(TPt.meta, Xt, 0.1 * Tt),
                 jtiled.retract_flat(TPj.meta, Xj, 0.1 * Tj))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_btd_graph_recurrences_match_loop(tiled_pair, dtype):
    """The op sequence the card's CUDA graph records (_btd_solve_into:
    one fused addmm per step into static buffers), run eagerly, against
    the plain loop of the CPU path."""
    _, TPt = tiled_pair
    m = TPt.meta
    Ltil, Sinv = TPt.btd_ltil.to(dtype), TPt.btd_sinv.to(dtype)
    for r_pad in (8, 16):
        V = torch.as_tensor(np.random.default_rng(r_pad).standard_normal(
            (r_pad, m.kpad)), dtype=dtype)
        bufs = [torch.zeros((m.nt, r_pad, m.T), dtype=dtype)
                for _ in range(3)]
        ttiled._btd_solve_into(Ltil, Sinv,
                               V.view(r_pad, m.nt, m.T).transpose(0, 1),
                               *bufs)
        out = bufs[2].transpose(0, 1).reshape(r_pad, m.kpad)
        ref = ttiled._precondition_btd(TPt, V)
        assert_close(out, ref, rtol=1e-12 if dtype == torch.float64
                     else 1e-5)


@pytest.mark.parametrize("which", ["critical", "saddle"])
def test_ra_certificate_blocks_and_apply_S(ra, which):
    key = "X" if which == "critical" else "X0"
    Cj = jcert.dual_certificate_blocks(ra["Pj"], ra[key + "j"])
    Ct = tcert.dual_certificate_blocks(ra["Pt"], ra[key + "t"])
    for a, b in zip(Ct, Cj):
        assert_close(a, b, rtol=1e-9)
    rng = np.random.default_rng(2)
    V = [rng.standard_normal(np.shape(a)) for a in ra["Xj"]]
    ref = jcert.apply_S(ra["Pj"], Cj, jlifted.RAState(*map(jnp.asarray, V)))
    out = tcert.apply_S(ra["Pt"], Ct, tlifted.RAState(*map(torch.as_tensor,
                                                           V)))
    assert_state_close(out, ref, rtol=1e-9)


def test_ra_host_Q_has_sphere_columns(ra):
    dims = ra["gj"].dims
    Qj = jcert._Q_host(ra["Pj"], dims)
    Qt = tcert._Q_host(ra["Pt"], dims)
    assert Qt.shape == (dims.k, dims.k)
    assert abs(Qt - Qj).max() <= 1e-12 * abs(Qj).max()
    sph = slice(dims.d * dims.n, dims.d * dims.n + dims.l)
    assert abs(Qt[sph]).max() > 0


@pytest.mark.parametrize("which", ["critical", "saddle"])
def test_ra_lanczos_same_v0(ra, tiled_pair, which):
    key = "X" if which == "critical" else "X0"
    dims = ra["gj"].dims
    atol = 1e-10 * float(tprob.power_iteration_lambda_max(
        ra["Pt"], tlifted.zeros(dims, 1)))
    Cj = jcert.dual_certificate_blocks(ra["Pj"], ra[key + "j"])
    Ct = tcert.dual_certificate_blocks(ra["Pt"], ra[key + "t"])
    v0 = np.random.default_rng(5).standard_normal(dims.k)
    lj, _, _ = jcert.minimum_eigen_pair(ra["Pj"], Cj, dims, 64, v0=v0)
    lt, vt, _ = tcert.minimum_eigen_pair(ra["Pt"], Ct, dims, 64, v0=v0)
    np.testing.assert_allclose(lt, lj, rtol=1e-8, atol=atol)
    assert vt.shape == (dims.k,)
    assert (lt >= -ETA) == (lj >= -ETA) == (which == "critical")
    TPj, TPt = tiled_pair
    lj, vj = jcert.minimum_eigen_pair_tiled(TPj, ra[key + "j"], 64)
    lt, vt = tcert.minimum_eigen_pair_tiled(TPt, ra[key + "t"], 64)
    np.testing.assert_allclose(lt, lj, rtol=1e-8, atol=100 * atol)
    assert (lt >= -ETA) == (lj >= -ETA) == (which == "critical")
    if which == "saddle":  # a well-separated bottom: the same vector
        assert_close(abs(np_of(vt)), abs(np.asarray(vj)), rtol=1e-6)


@pytest.mark.parametrize("which", ["critical", "saddle"])
def test_ra_fast_verification_verdict(ra, which):
    """The verdict with the f32 tiles (TP.f32, as the staircase passes
    them): the critical point certifies at eta 1e-4, the saddle does not."""
    key = "X" if which == "critical" else "X0"
    gj = ra["gj"]
    TPj = jtiled.build_tiled(ra["Pj"], gj.dims, dtype=np.float32,
                             with_pallas=False)
    TPt = ttiled.build_tiled(ra["Pt"], gj.dims, dtype=torch.float32)
    okj, thj, _ = jcert.fast_verification(ra["Pj"], ra[key + "j"], ETA, 64,
                                          TP=TPj)
    okt, tht, _ = tcert.fast_verification(ra["Pt"], ra[key + "t"], ETA, 64,
                                          TP=TPt)
    assert okt == okj == (which == "critical")
    if not okj:
        assert tht < -ETA and thj < -ETA


def test_ra_escape_saddle_matches(ra):
    """From the saddle, along the same direction, with M: the same verdict
    and the same rank-4 point."""
    Xj, Xt, Pj, Pt = ra["X0j"], ra["X0t"], ra["Pj"], ra["Pt"]
    Cj = jcert.dual_certificate_blocks(Pj, Xj)
    theta, v, _ = jcert.minimum_eigen_pair(Pj, Cj, Xj.dims, 64)
    assert theta < 0
    okj, Yj = jcert.escape_saddle(Pj, Xj, theta, v, 4, M=ra["Mj"],
                                  is_second_order=True)
    okt, Yt = tcert.escape_saddle(Pt, Xt, theta, torch.tensor(v), 4,
                                  M=convert.preconditioner(ra["Mj"]),
                                  is_second_order=True)
    assert okt == okj
    assert Yt.r == 4
    assert_state_close(Yt, Yj)


def test_ra_round_solution_matches_up_to_gauge(ra):
    """Rounding projects the Stiefel blocks to SO(3) and the spheres back
    to unit length: the gauge-invariant Gram matrix and the cost agree."""
    X4j = jlifted.pad_rank(ra["Xj"], 4)
    Rj = jcert.round_solution(X4j)
    Rt = tcert.round_solution(tlifted.pad_rank(ra["Xt"], 4))
    Fj = np.asarray(jlifted.to_flat(Rj))
    Ft = np_of(tlifted.to_flat(Rt))
    assert Ft.shape[0] == 3
    assert_close(Ft.T @ Ft, Fj.T @ Fj)
    assert_close(tprob.cost(ra["Pt"], Rt), jprob.cost(ra["Pj"], Rj))
    np.testing.assert_allclose(np.linalg.norm(np_of(Rt.sph), axis=1), 1.0,
                               atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(np_of(Rt.rot)), 1.0,
                               atol=1e-12)


def test_ra_convert_tiled_problem(tiled_pair):
    """convert.tiled_problem carries an RA JAX build across whole: the
    tiles, the maps, the sphere and landmark inverses and the BTD factor
    equal the port's own build."""
    TPj, TPt = tiled_pair
    TPc = convert.tiled_problem(TPj)
    for name in ("tiles", "tile_rows", "tile_cols", "ra_of_fl", "fl_of_ra"):
        assert torch.equal(getattr(TPc.Q, name), getattr(TPt.Q, name)), name
    for name in ("pose_inv", "sph_inv", "lmk_inv", "btd_ltil", "btd_sinv"):
        assert_close(getattr(TPc, name), getattr(TPt, name))
    assert TPc.meta == TPt.meta
