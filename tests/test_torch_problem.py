"""Edge-path cost engine, manifold, preconditioner and initialization of
the PyTorch port vs the JAX package, on a random graph with every
measurement type, random weights and a prior (f64, 1e-10 relative)."""

import numpy as np
import pytest
import torch

import dcora_tpu.core.init as jinit
import dcora_tpu.core.manifold as jman
import dcora_tpu.core.problem as jprob
import dcora_tpu.datasets as jds
import dcora_tpu.io as jio
import dcora_tpu_torch.core.init as tinit
import dcora_tpu_torch.core.manifold as tman
import dcora_tpu_torch.core.problem as tprob
import dcora_tpu_torch.io as tio
from dcora_tpu_torch import convert
from dcora_tpu_torch.core import lifted as tlifted
from torch_port_common import (
    assert_close,
    assert_segments_equal,
    assert_state_close,
    build_graphs,
    jax_state,
    random_graph_spec,
    random_state_arrays,
    torch_state,
)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    gj, gt = build_graphs(random_graph_spec(rng))
    Pj = gj.problem_data()
    Pt = convert.problem_data(Pj)
    arrs = random_state_arrays(rng, gj.dims, gj.r)
    V = [rng.standard_normal(a.shape) for a in arrs]
    return dict(gj=gj, gt=gt, Pj=Pj, Pt=Pt, Xj=jax_state(arrs),
                Xt=torch_state(arrs), Vj=jax_state(V), Vt=torch_state(V))


def test_problem_data_from_graph_matches_converted(case):
    """LocalGraph.problem_data of the port == the JAX SoA carried across."""
    Pg = case["gt"].problem_data()
    Pc = case["Pt"]
    for name in tprob.ProblemData._fields:
        a, b = getattr(Pg, name), getattr(Pc, name)
        if name == "prior_G":
            for x, y in zip(a, b):
                assert torch.equal(x, y), name
        elif a is None or b is None:
            assert a is None and b is None, name
        elif name == "seg":
            assert_segments_equal(a, b)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("op", ["apply_Q", "egrad", "hessian_vec",
                                "linear_term"])
def test_edge_operators(case, op):
    Pj, Pt = case["Pj"], case["Pt"]
    if op == "apply_Q":
        ref = jprob.apply_Q(Pj, case["Xj"])
        out = tprob.apply_Q(Pt, case["Xt"])
    elif op == "egrad":
        ref = jprob.euclidean_gradient(Pj, case["Xj"], Pj.prior_G)
        out = tprob.euclidean_gradient(Pt, case["Xt"], Pt.prior_G)
    elif op == "hessian_vec":
        ref = jprob.hessian_vec(Pj, case["Vj"])
        out = tprob.hessian_vec(Pt, case["Vt"])
    else:
        d = case["gj"].dims
        ref = jprob.linear_term(Pj, None, d.n, d.l, d.num_trans)
        out = tprob.linear_term(Pt, None, d.n, d.l, d.num_trans)
    assert_state_close(out, ref)


def test_cost(case):
    Pj, Pt = case["Pj"], case["Pt"]
    for G in ("none", "prior"):
        ref = jprob.cost(Pj, case["Xj"], Pj.prior_G if G == "prior" else None)
        out = tprob.cost(Pt, case["Xt"], Pt.prior_G if G == "prior" else None)
        assert_close(out, ref)


def test_preconditioner_build_and_apply(case):
    g = case["gj"]
    Mj = jprob.build_preconditioner_host(case["Pj"], g.n, g.l, g.b, g.d, 0.1)
    Mt = tprob.build_preconditioner_host(case["Pt"], g.n, g.l, g.b, g.d, 0.1)
    for a, b in zip(Mt, Mj):
        assert_close(a, b)
    # the on-device JAX build agrees too
    Mj2 = jprob.build_preconditioner(case["Pj"], g.n, g.l, g.b, g.d, 0.1)
    for a, b in zip(Mt, Mj2):
        assert_close(a, b)
    ref = jprob.apply_preconditioner(Mj, case["Vj"])
    out = tprob.apply_preconditioner(convert.preconditioner(Mj), case["Vt"])
    assert_state_close(out, ref)


def test_power_iteration(case):
    from dcora_tpu.core import lifted as jlifted

    d = case["gj"].dims
    ref = jprob.power_iteration_lambda_max(case["Pj"], jlifted.zeros(d, 1))
    out = tprob.power_iteration_lambda_max(case["Pt"], tlifted.zeros(d, 1))
    assert_close(out, ref)


@pytest.mark.parametrize("op", ["tangent_project", "retract", "project",
                                "flat_roundtrip"])
def test_manifold_ops(case, op):
    Xj, Xt, Vj, Vt = case["Xj"], case["Xt"], case["Vj"], case["Vt"]
    if op == "tangent_project":
        ref, out = jman.tangent_project(Xj, Vj), tman.tangent_project(Xt, Vt)
    elif op == "retract":
        Tj = jman.tangent_project(Xj, Vj)
        Tt = convert.ra_state(Tj)
        ref, out = jman.retract(Xj, Tj), tman.retract(Xt, Tt)
        assert float(tman.manifold_error(out)) < 1e-12
    elif op == "project":
        ref, out = jman.project(Vj), tman.project(Vt)
    else:
        from dcora_tpu.core import lifted as jlifted

        ref = jlifted.to_flat(Xj)
        out = tlifted.to_flat(Xt)
        assert_close(out, ref, rtol=0)
        back = tlifted.from_flat(out, case["gj"].dims)
        assert_state_close(back, Xt, rtol=0)
        return
    assert_state_close(out, ref)


def test_rotation_project_batch():
    rng = np.random.default_rng(3)
    M = rng.standard_normal((20, 3, 3))
    ref = np.asarray(jman.rotation_project(M))
    out = tman.rotation_project(torch.as_tensor(M))
    assert_close(out, ref)


@pytest.fixture(scope="module")
def grid_measurements(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grid") / "g.g2o")
    jds.generate_grid_g2o(path, shape=(4, 4, 3), rot_noise=0.08,
                          trans_noise=0.05, seed=9)
    return (jio.read_g2o_file(path).pose_pose_measurements,
            tio.read_g2o_file(path).pose_pose_measurements)


def test_chordal_initialization(grid_measurements):
    ms_j, ms_t = grid_measurements
    ref = jinit.chordal_initialization(ms_j)
    out = tinit.chordal_initialization(ms_t, device="cpu")
    assert_close(out, ref)


def test_odometry_initialization(grid_measurements):
    ms_j, ms_t = grid_measurements
    odo_j = [m for m in ms_j if m.p1 + 1 == m.p2]
    odo_t = [m for m in ms_t if m.p1 + 1 == m.p2]
    # the JAX package may parse with its native library: ulp-level input
    # differences, hence a tolerance rather than equality
    assert_close(tinit.odometry_initialization(odo_t),
                 jinit.odometry_initialization(odo_j))


def test_from_pose_array_and_rank_padding():
    from dcora_tpu.core import lifted as jlifted

    rng = np.random.default_rng(2)
    T = rng.standard_normal((6, 3, 4))
    ref = jlifted.pad_rank(jlifted.from_pose_array(T), 5)
    out = tlifted.pad_rank(tlifted.from_pose_array(T), 5)
    assert_state_close(out, ref, rtol=0)
    assert_state_close(tlifted.truncate_rank(out, 3),
                       jlifted.truncate_rank(ref, 3), rtol=0)
