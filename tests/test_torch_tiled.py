"""Tiled block-sparse path and the SpMM kernel module of the PyTorch port vs
the JAX package: the host tile build, apply_tiled (spmm_sym_plain on the
CPU) against JAX's apply_tiled and its Pallas kernel in interpret mode,
the kernel's strip CSR, and the flat manifold/preconditioner ops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcora_tpu.core.tiled as jtiled
import dcora_tpu_torch.core.tiled as ttiled
from dcora_tpu.core import pallas_spmm
from dcora_tpu_torch import convert
from dcora_tpu_torch.core import spmm
from torch_port_common import (
    F32_ATOL,
    assert_close,
    assert_state_close,
    build_graphs,
    jax_state,
    np_of,
    random_graph_spec,
    random_state_arrays,
    torch_state,
)

MODES = {"pose": False, "tile": True, "btd": "btd"}


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(3)
    gj, gt = build_graphs(random_graph_spec(rng, n=40, l=9, b=6))
    return gj, gt, gj.problem_data(), gt.problem_data()


def _build_pair(graphs, mode, dtype, T=128):
    gj, gt, Pj, Pt = graphs
    jdt = np.float32 if dtype == torch.float32 else np.float64
    TPj = jtiled.build_tiled(Pj, gj.dims, T=T, dtype=jdt, reg=0.1,
                             tile_precond=MODES[mode], with_pallas=False)
    TPt = ttiled.build_tiled(Pt, gt.dims, T=T, dtype=dtype, reg=0.1,
                             tile_precond=MODES[mode])
    return TPj, TPt


@pytest.mark.parametrize("mode", sorted(MODES))
def test_build_tiled_arrays_match(graphs, mode):
    TPj, TPt = _build_pair(graphs, mode, torch.float64, T=32)
    assert TPt.meta.nt == TPj.meta.nt and TPt.meta.k == TPj.meta.k
    rows, cols = np.asarray(TPj.Q.tile_rows), np.asarray(TPj.Q.tile_cols)
    up = rows <= cols
    np.testing.assert_array_equal(np_of(TPt.Q.tile_rows), rows[up])
    np.testing.assert_array_equal(np_of(TPt.Q.tile_cols), cols[up])
    np.testing.assert_array_equal(np_of(TPt.Q.tiles),
                                  np.asarray(TPj.Q.tiles)[up])
    np.testing.assert_array_equal(np_of(TPt.Q.ra_of_fl), TPj.Q.ra_of_fl)
    np.testing.assert_array_equal(np_of(TPt.Q.fl_of_ra), TPj.Q.fl_of_ra)
    assert_close(TPt.pose_inv, np.asarray(TPj.pose_inv).transpose(2, 0, 1))
    for name in ("sph_inv", "lmk_inv", "diag_inv", "btd_ltil", "btd_sinv"):
        a, b = getattr(TPt, name), getattr(TPj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert_close(a, b)


def test_convert_from_bucketed_groups(graphs):
    """The upper tile list recovered from the Pallas kernel's bucketed
    wide buffers is the port's own tile list."""
    gj, gt, Pj, Pt = graphs
    TPj = jtiled.build_tiled(Pj, gj.dims, dtype=np.float32, with_pallas=True)
    assert TPj.Q.grp_buckets is not None
    TPc = convert.tiled_problem(TPj)
    TPt = ttiled.build_tiled(Pt, gt.dims, dtype=torch.float32)
    for name in ("tiles", "tile_rows", "tile_cols", "ra_of_fl", "fl_of_ra"):
        assert torch.equal(getattr(TPc.Q, name), getattr(TPt.Q, name)), name
    for name, a, b in zip(spmm.StripCSR._fields, TPc.Q.strips,
                          TPt.Q.strips):
        assert torch.equal(a, b), name


def _emulate_kernel(TP, X):
    """The CUDA kernel's traversal in numpy: per output strip s of B
    columns, its entries in order, W[:, sB:sB+B] += X[:, src B:+B] A^T."""
    ptr, src, vals = (np_of(a) for a in TP.Q.strips)
    B = vals.shape[-1]
    X = np_of(X)
    W = np.zeros_like(X)
    for s in range(len(ptr) - 1):
        for e in range(ptr[s], ptr[s + 1]):
            W[:, s * B:(s + 1) * B] += X[:, src[e] * B:(src[e] + 1) * B] \
                @ vals[e].T
    return W


@pytest.mark.parametrize("r_pad", [1, 8, 16])
def test_output_csr_matches_plain(graphs, r_pad):
    """The strip CSR the kernel reads reproduces the plain SpMM over the
    dense tiles."""
    _, TPt = _build_pair(graphs, "pose", torch.float64)
    rng = np.random.default_rng(r_pad)
    X = torch.as_tensor(rng.standard_normal((r_pad, TPt.meta.kpad)))
    Q = TPt.Q
    assert_close(_emulate_kernel(TPt, X),
                 spmm.spmm_sym_plain(Q.tiles, Q.tile_rows, Q.tile_cols, X),
                 rtol=1e-13)
    ptr, src = np_of(Q.strips.ptr), np_of(Q.strips.src)
    assert ptr[0] == 0 and ptr[-1] == len(src)
    assert np.all(np.diff(ptr) >= 0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T", [16, 128])
def test_apply_tiled_matches_jax(graphs, dtype, T):
    TPj, TPt = _build_pair(graphs, "pose", dtype, T=T)
    rng = np.random.default_rng(7)
    X = rng.standard_normal((8, TPt.meta.kpad))
    ref = jtiled.apply_tiled(TPj, jnp.asarray(X, TPj.Q.tiles.dtype))
    out = ttiled.apply_tiled(TPt, torch.as_tensor(X, dtype=dtype))
    assert out.dtype == dtype
    assert_close(out, ref, rtol=1e-12 if dtype == torch.float64
                 else F32_ATOL)


def test_apply_tiled_matches_pallas_interpret(graphs):
    """Against the TPU kernel itself (spmm_bucketed, interpret mode, as
    tests/test_tiled.py runs it)."""
    gj, gt, Pj, Pt = graphs
    TPj = jtiled.build_tiled(Pj, gj.dims, dtype=np.float32, with_pallas=True)
    TPt = ttiled.build_tiled(Pt, gt.dims, dtype=torch.float32)
    rng = np.random.default_rng(5)
    X = rng.standard_normal((8, TPt.meta.kpad)).astype(np.float32)
    ref = pallas_spmm.spmm_bucketed(TPj.Q.grp_buckets, jnp.asarray(X),
                                    T=128, interpret=True)
    out = ttiled.apply_tiled(TPt, torch.as_tensor(X))
    assert_close(out, ref, rtol=F32_ATOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_flat_ops_match_jax(graphs, mode):
    gj, gt, Pj, Pt = graphs
    TPj, TPt = _build_pair(graphs, mode, torch.float64, T=32)
    meta_j, meta_t = TPj.meta, TPt.meta
    rng = np.random.default_rng(11)
    arrs = random_state_arrays(rng, gj.dims, 5)
    Xj = jtiled.to_flat(TPj, jax_state(arrs), r_pad=8)
    Xt = ttiled.to_flat(TPt, torch_state(arrs), r_pad=8)
    assert_close(Xt, Xj, rtol=0)
    V = rng.standard_normal(Xt.shape)
    V[5:] = 0.0
    Vj, Vt = jnp.asarray(V), torch.as_tensor(V)

    assert_close(ttiled.precondition_flat(TPt, Vt),
                 jtiled.precondition_flat(TPj, Vj))
    Tj = jtiled.tangent_project_flat(meta_j, Xj, Vj)
    Tt = ttiled.tangent_project_flat(meta_t, Xt, Vt)
    assert_close(Tt, Tj)
    Gj, Gt = jtiled.egrad_flat(TPj, Xj), ttiled.egrad_flat(TPt, Xt)
    assert_close(Gt, Gj)
    assert_close(ttiled.cost_flat(TPt, Xt), jtiled.cost_flat(TPj, Xj))
    assert_close(ttiled.weingarten_apply(
                     meta_t, Tt, ttiled.weingarten_setup(meta_t, Xt, Gt)),
                 jtiled.weingarten_apply(
                     meta_j, Tj, jtiled.weingarten_setup(meta_j, Xj, Gj)))
    Rj = jtiled.retract_flat(meta_j, Xj, 0.1 * Tj)
    Rt = ttiled.retract_flat(meta_t, Xt, 0.1 * Tt)
    assert_close(Rt, Rj)
    assert_state_close(ttiled.from_flat(TPt, Rt, r=5),
                       jtiled.from_flat(TPj, Rj, r=5))


def test_spmm_sym_rejects_what_the_kernel_does_not_take(graphs):
    _, TPt = _build_pair(graphs, "pose", torch.float64)
    S = TPt.Q.strips
    X = torch.zeros((8, TPt.meta.kpad), dtype=torch.float64)
    with pytest.raises(TypeError):
        spmm.spmm_sym(S, X.float())
    with pytest.raises(ValueError):
        spmm.spmm_sym(S, X[:, :-1])
    with pytest.raises(ValueError):
        spmm.spmm_sym(S, X[0])
    with pytest.raises(ValueError, match="do not index"):
        spmm.spmm_sym(S._replace(src=S.src[:-1]), X)
    # a tensor on any device other than the CPU never takes the plain path
    with pytest.raises(ValueError, match="unsupported device"):
        spmm.spmm_sym(spmm.StripCSR(*(a.to("meta") for a in S)),
                      X.to("meta"))
    before = spmm.spmm_sym.launches
    spmm.spmm_sym(S, X)
    assert spmm.spmm_sym.launches == before  # the plain path launches none


def test_build_output_csr_rejects_lower_tiles():
    with pytest.raises(ValueError):
        spmm.build_output_csr(np.array([1]), np.array([0]),
                              np.ones((1, 8, 8)), 2)

