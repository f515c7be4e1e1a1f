"""The flat layout's per-pose Riemannian ops of the PyTorch port against the
JAX package: the plain versions of the two kernels of
dcora_tpu_torch/csrc/flat_ops.cu (flat_rhess: the projection with the
Weingarten term, and the Grams of weingarten_setup; flat_precond: the
per-pose block-Jacobi solve fused with the projection) and the wrappers
on CPU tensors, held to the JAX package's tangent_project_flat,
weingarten_setup / weingarten_apply and precondition_flat compositions
on the same numpy-seeded inputs.

Covered: d = 2 and 3; PGO (poses only) and RA layouts (spheres and
landmarks); r_pad 8 and 16 with zero rows past the rank; the per-pose,
tile and BTD preconditioners.  f64 to 1e-12 relative to the reference's
max.  Also: a [r_pad, A, kpad] stack equals its agents one by one, the
wrappers refuse what the kernels do not take, and _FlatBackend.rhess
equals the composition the tCG ran before it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcora_tpu.core.tiled as jtiled
import dcora_tpu_torch.core.tiled as ttiled
from dcora_tpu_torch.core import kernels, rtr
from torch_port_common import (
    assert_close,
    build_graphs,
    jax_state,
    random_graph_spec,
    random_state_arrays,
    torch_state,
)

RTOL = 1e-12
MODES = {"pose": False, "tile": True, "btd": "btd"}
LAYOUTS = {"pgo": (0, 0), "ra": (9, 6)}  # (spheres, landmarks)
RANK = 5


def _spec(rng, d, l, b):  # noqa: E741
    spec = random_graph_spec(rng, n=40, l=l, b=b, d=d)
    if d == 2:  # planar rotations in place of the helper's 3D ones
        for kind, kw in spec:
            if kind == "pp":
                a = rng.uniform(-np.pi, np.pi)
                kw["R"] = np.array([[np.cos(a), -np.sin(a)],
                                    [np.sin(a), np.cos(a)]])
    return spec


@pytest.fixture(scope="module", params=[(d, lay) for d in (2, 3)
                                        for lay in sorted(LAYOUTS)],
                ids=lambda p: f"d{p[0]}-{p[1]}")
def graphs(request):
    d, lay = request.param
    rng = np.random.default_rng(17 + d)
    gj, gt = build_graphs(_spec(rng, d, *LAYOUTS[lay]), d=d, r=RANK)
    return gj, gt, gj.problem_data(), gt.problem_data()


def _build_pair(graphs, mode, T=32):
    gj, gt, Pj, Pt = graphs
    TPj = jtiled.build_tiled(Pj, gj.dims, T=T, dtype=np.float64, reg=0.1,
                             tile_precond=MODES[mode], with_pallas=False)
    TPt = ttiled.build_tiled(Pt, gt.dims, T=T, dtype=torch.float64, reg=0.1,
                             tile_precond=MODES[mode])
    return TPj, TPt


def _inputs(graphs, TPj, TPt, r_pad, seed):
    """X on the manifold at rank 5 (zero rows up to r_pad) in both
    engines, and random V, eta with the same zero rows."""
    gj = graphs[0]
    rng = np.random.default_rng(seed)
    arrs = random_state_arrays(rng, gj.dims, RANK)
    Xj = jtiled.to_flat(TPj, jax_state(arrs), r_pad=r_pad)
    Xt = ttiled.to_flat(TPt, torch_state(arrs), r_pad=r_pad)
    assert_close(Xt, Xj, rtol=0)
    out = []
    for _ in range(2):
        V = rng.standard_normal(tuple(Xt.shape))
        V[RANK:] = 0.0
        out.append((jnp.asarray(V), torch.as_tensor(V)))
    return (Xj, Xt), *out


@pytest.mark.parametrize("r_pad", [8, 16])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_ops_match_jax(graphs, mode, r_pad):
    TPj, TPt = _build_pair(graphs, mode)
    mj, mt = TPj.meta, TPt.meta
    (Xj, Xt), (Vj, Vt), (Ej, Et) = _inputs(graphs, TPj, TPt, r_pad,
                                           seed=r_pad)
    # the projection (flat_rhess without the Weingarten term)
    Tj = jtiled.tangent_project_flat(mj, Xj, Vj)
    for out in (ttiled._tangent_project_plain(mt, Xt, Vt),
                ttiled.tangent_project_flat(mt, Xt, Vt)):
        assert_close(out, Tj, rtol=RTOL)
        assert not out[RANK:].any()
    # the Weingarten constants at egrad = X Q, and the fused Hessian
    Gj, Gt = jtiled.egrad_flat(TPj, Xj), ttiled.egrad_flat(TPt, Xt)
    auxj = jtiled.weingarten_setup(mj, Xj, Gj)
    auxt = ttiled.weingarten_setup(mt, Xt, Gt)
    Ssym_j = np.stack([np.stack(row, -1) for row in auxj[0]], -2)
    assert_close(auxt[0], Ssym_j, rtol=RTOL)
    assert auxt[1].shape == (1, mt.l)
    if mt.l:
        assert_close(auxt[1], auxj[1], rtol=RTOL)
    HVj = jtiled.apply_tiled(TPj, Ej)
    HVt = ttiled.apply_tiled(TPt, Et)
    ref = jtiled.tangent_project_flat(
        mj, Xj, HVj - jtiled.weingarten_apply(mj, Ej, auxj))
    for out in (ttiled._rhess_plain(mt, Xt, HVt, Et, auxt),
                ttiled.flat_rhess(mt, Xt, HVt, Et, auxt)):
        assert_close(out, ref, rtol=RTOL)
        assert not out[RANK:].any()
    # without the projection: the certifier's Hessian operator
    assert_close(ttiled.flat_rhess(mt, None, HVt, Et, auxt, project=False),
                 HVj - jtiled.weingarten_apply(mj, Ej, auxj), rtol=RTOL)
    # the preconditioner, then the projection (flat_precond on per-pose)
    ref = jtiled.tangent_project_flat(mj, Xj,
                                      jtiled.precondition_flat(TPj, Vj))
    assert_close(ttiled.precond_project(TPt, Xt, Vt), ref, rtol=RTOL)
    if mode == "pose":
        assert_close(ttiled.flat_precond(TPt, Xt, Vt), ref, rtol=RTOL)
        assert_close(ttiled._precondition_pose_plain(TPt, Vt),
                     jtiled.precondition_flat(TPj, Vj), rtol=RTOL)


def _stack(TP, A, rng):
    """A stack of A agents sharing TP's layout and Q, each with its own
    per-pose Jacobi blocks (TP's, scaled per pose) and tail inverses."""
    def varied(x):
        s = torch.as_tensor(rng.uniform(0.5, 2.0, (A,) + tuple(
            x.shape[:1])), dtype=x.dtype)
        return (s.view(s.shape + (1,) * (x.dim() - 1)) * x).contiguous()

    TPs = dataclasses.replace(TP, pose_inv=varied(TP.pose_inv),
                              sph_inv=varied(TP.sph_inv),
                              lmk_inv=varied(TP.lmk_inv))
    agents = [dataclasses.replace(TP, pose_inv=TPs.pose_inv[a],
                                  sph_inv=TPs.sph_inv[a],
                                  lmk_inv=TPs.lmk_inv[a]) for a in range(A)]
    return TPs, agents


@pytest.mark.parametrize("r_pad", [8, 16])
def test_stack_equals_its_agents(graphs, r_pad):
    """[r_pad, A, kpad]: every op equals the same op on each agent's
    [r_pad, kpad] slice (to rounding: torch's CPU sums over the rows of
    a stack and of one agent may group the rows in another order)."""
    _, TP = _build_pair(graphs, "pose")
    meta, A = TP.meta, 3
    rng = np.random.default_rng(r_pad + 100)
    TPs, agents = _stack(TP, A, rng)
    gt = graphs[1]
    X = torch.stack([ttiled.to_flat(TP, torch_state(random_state_arrays(
        rng, gt.dims, RANK)), r_pad=r_pad) for _ in range(A)], 1)
    V, E, HV = (torch.as_tensor(rng.standard_normal(X.shape)) for _ in
                range(3))
    for T in (V, E, HV):
        T[RANK:] = 0.0
    X, V, E, HV = (t.contiguous() for t in (X, V, E, HV))
    aux = ttiled.weingarten_setup(meta, X, V)
    assert aux[0].shape == (A, meta.n, meta.d, meta.d)
    assert aux[1].shape == (1, A, meta.l)
    outs = dict(
        tangent=ttiled.tangent_project_flat(meta, X, V),
        rhess=ttiled.flat_rhess(meta, X, HV, E, aux),
        precond=ttiled.flat_precond(TPs, X, V))
    for a in range(A):
        Xa, Va, Ea, Ha = (t[:, a].contiguous() for t in (X, V, E, HV))
        aux_a = ttiled.weingarten_setup(meta, Xa, Va)
        assert_close(aux[0][a], aux_a[0], rtol=RTOL)
        assert_close(aux[1][:, a], aux_a[1], rtol=RTOL)
        want = dict(
            tangent=ttiled.tangent_project_flat(meta, Xa, Va),
            rhess=ttiled.flat_rhess(meta, Xa, Ha, Ea, aux_a),
            precond=ttiled.flat_precond(agents[a], Xa, Va))
        for name, out in outs.items():
            assert_close(out[:, a], want[name], rtol=RTOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(graphs):
    _, TP = _build_pair(graphs, "pose")
    meta = TP.meta
    rng = np.random.default_rng(5)
    X, V = (torch.as_tensor(rng.standard_normal((8, meta.kpad)))
            for _ in range(2))
    aux = ttiled.weingarten_setup(meta, X, V)
    before = kernels.launch_counts()
    with pytest.raises(TypeError):
        ttiled.flat_rhess(meta, X, V.float())
    with pytest.raises(TypeError):
        ttiled.flat_precond(TP, X.float(), V.float())  # f64 inverses
    with pytest.raises(TypeError):
        ttiled.flat_rhess(meta, X, V, V, (aux[0].float(), aux[1]))
    with pytest.raises(ValueError):
        ttiled.tangent_project_flat(meta, X[:, :-1], V[:, :-1])
    with pytest.raises(ValueError):
        ttiled.flat_rhess(meta, X, V[:4])
    with pytest.raises(ValueError):
        ttiled.flat_rhess(meta, X[0], V[0])
    with pytest.raises(ValueError, match="contiguous"):
        ttiled.flat_rhess(meta, X, V.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        ttiled.flat_precond(TP, X, V[:, ::1].t().contiguous().t())
    with pytest.raises(ValueError):
        ttiled.flat_rhess(meta, X, V, V, (aux[0][:-1], aux[1]))
    with pytest.raises(ValueError, match="needs X"):
        ttiled.flat_rhess(meta, None, V)
    with pytest.raises(ValueError):
        ttiled.flat_rhess(dataclasses.replace(meta, d=4), X, V)
    with pytest.raises(ValueError):
        ttiled.flat_precond(dataclasses.replace(
            TP, pose_inv=TP.pose_inv[:-1]), X, V)
    # a tensor on any device other than the CPU never takes the plain path
    with pytest.raises(ValueError, match="unsupported device"):
        ttiled.flat_rhess(meta, X.to("meta"), V.to("meta"))
    assert kernels.launch_counts() == before  # the plain path launches none


def test_jacobi_cast_kept_per_dtype(graphs):
    """The inverses at a dtype are made once and kept on the problem;
    dataclasses.replace does not carry them over."""
    _, TP = _build_pair(graphs, "pose")
    X = torch.zeros((8, TP.meta.kpad), dtype=torch.float64)
    ttiled.flat_precond(TP, X, X)
    got = TP.jacobi[torch.float64]
    ttiled.flat_precond(TP, X, X)
    assert TP.jacobi[torch.float64] is got
    f32 = ttiled._jacobi(TP, torch.float32)
    assert f32[0].dtype == torch.float32 and len(TP.jacobi) == 2
    assert dataclasses.replace(TP).jacobi == {}
    assert dataclasses.replace(TP).tcg_graphs == {}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_flat_backend_rhess_equals_the_old_composition(graphs, mode):
    """_FlatBackend.rhess (the SpMM, then one flat_rhess) and its fused
    precond against P_X(Q eta - W(eta)) and P_X(M^-1 v) from their parts,
    as the tCG composed them before: on the CPU the same ops, so the same
    bits."""
    _, TP = _build_pair(graphs, mode)
    (_, X), (_, V), (_, E) = _inputs(graphs, *_build_pair(graphs, mode), 8,
                                     seed=3)
    be, meta = rtr.FLAT_BACKEND, TP.meta
    aux = be.hess_setup(TP, X, ttiled.egrad_flat(TP, X))
    old = ttiled._tangent_project_plain(
        meta, X, ttiled.apply_tiled(TP, E) - ttiled.weingarten_apply(
            meta, E, aux))
    assert torch.equal(be.rhess(TP, X, E, aux), old)
    assert torch.equal(
        be.precond(TP, None, X, V),
        ttiled._tangent_project_plain(meta, X,
                                      ttiled.precondition_flat(TP, V)))
    # off the card no graph is kept
    assert rtr.tcg_graph(be, TP, X, 10) is None and TP.tcg_graphs == {}


def test_count_products_counts_eager_calls(graphs):
    """tools.common.count_products counts apply_tiled calls issued eagerly
    (on the CPU no graph records one) and undoes its patching."""
    from dcora_tpu_torch.tools import common

    TPj, TP = _build_pair(graphs, "pose")
    (_, X), _, _ = _inputs(graphs, TPj, TP, 8, seed=1)
    real = ttiled.apply_tiled
    products, restore = common.count_products()
    try:
        rtr.rtr(TP, None, None, X, rtr.RTRConfig(max_outer=1, max_inner=3),
                be=rtr.FLAT_BACKEND)
        assert products[0] >= 3
    finally:
        restore()
    assert ttiled.apply_tiled is real
    assert rtr.TCGGraph._record is not None and \
        "record" not in rtr.TCGGraph.replay.__qualname__
