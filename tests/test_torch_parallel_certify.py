"""The port's sharded certificate (dcora_tpu_torch.parallel.certify)
against the JAX package's (dcora_tpu.parallel.certify, on a mesh of as many
virtual CPU devices as shards) at 1, 2 and 4 shards, on the generated
smallGrid3D set at rank 5:

  * the edge shards (zero-weight padding) exactly (both engines get the
    same ProblemData, through dcora_tpu_torch.convert), and the sharded S
    matvec to 1e-12 of max|S v|, and against the central core.certify
    apply_S;
  * lambda_min at a random point on the manifold to 1e-9 relative of
    JAX's at 4 shards and of the central core.certify's (the tests compare
    eigenvalues, not vectors: the fresh Lanczos vectors after a breakdown
    come from a torch.Generator where JAX draws from jax.random);
  * the sharded verification: certified at the central optimum, as JAX's
    at 4 shards; refuted at the random point by a Rayleigh quotient equal
    to JAX's lambda_min (1e-8).
"""

import os

import numpy as np
import pytest
import torch
from torch_port_common import random_state_arrays

SHARDS = [1, 2, 4]
JAX_SHARDS = 4
MATVEC_RTOL = 1e-12
EIG_RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(data_dir):
    """(JAX problem, port problem, {"random", "optimum"}: numpy states)."""
    from dcora_tpu.core.graph import LocalGraph as JG
    from dcora_tpu.io import read_g2o_file as jread
    from dcora_tpu_torch import convert
    from dcora_tpu_torch.core import lifted
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.core.init import chordal_initialization
    from dcora_tpu_torch.core.rtr import RTRConfig, rtr
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.solvers import make_preconditioner

    path = os.path.join(data_dir, "smallGrid3D.g2o")
    gj = JG(0, 5, 3)
    gj.set_measurements(jread(path).pose_pose_measurements)
    Pj = gj.problem_data()
    ms = read_g2o_file(path).pose_pose_measurements
    g = LocalGraph(0, 5, 3)
    g.set_measurements(ms)
    P = convert.problem_data(Pj)  # the same numbers in both engines
    X0 = lifted.pad_rank(lifted.from_pose_array(
        chordal_initialization(ms, device="cpu")), 5)
    Xopt = rtr(P, lifted.zeros(g.dims, 5), make_preconditioner(g, P), X0,
               RTRConfig(gradnorm_tol=1e-6, max_outer=200,
                         max_inner=200)).X
    states = dict(
        random=random_state_arrays(np.random.default_rng(7), g.dims, 5),
        optimum=tuple(x.numpy() for x in Xopt))
    return Pj, P, states


def _mesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("agents",))


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_matvec_matches_jax(setup, shards):
    import jax
    import jax.numpy as jnp

    from dcora_tpu.core import certify as jcert
    from dcora_tpu.parallel import certify as jpar
    from dcora_tpu_torch import convert
    from dcora_tpu_torch.core import certify, lifted
    from dcora_tpu_torch.parallel.certify import (
        make_sharded_matvec,
        shard_problem_edges,
    )
    from torch_port_common import jax_state, torch_state

    Pj, P, states = setup
    Xj, X = jax_state(states["random"]), torch_state(states["random"])
    Pj_sh = jpar.shard_problem_edges(Pj, shards)
    P_sh = shard_problem_edges(P, shards)
    for name in convert.prob.ProblemData._fields[:24]:
        got, want = getattr(P_sh, name).numpy(), np.asarray(
            getattr(Pj_sh, name))
        assert got.shape == want.shape, name
        assert np.array_equal(got, want), name
    C = certify.dual_certificate_blocks(P, X)
    v = np.random.default_rng(0).standard_normal(X.dims.k)
    want = np.asarray(jax.jit(jpar.make_sharded_matvec(
        Pj_sh, jcert.dual_certificate_blocks(Pj, Xj), Xj.dims,
        _mesh(shards)))(jnp.asarray(v), jnp.zeros(())))
    vt = torch.as_tensor(v)
    got = make_sharded_matvec(P_sh, C, X.dims)(vt, torch.zeros(()))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= MATVEC_RTOL * scale
    central = lifted.to_flat(certify.apply_S(
        P, C, lifted.from_flat(vt[None], X.dims)))[0]
    assert float((got - central).abs().max()) <= MATVEC_RTOL * scale


@pytest.fixture(scope="module")
def jax_ref(setup):
    """The JAX package's lambda_min at the random point and verdict at the
    optimum, at JAX_SHARDS shards (each JAX call traces its Lanczos anew,
    ~15 s on a CPU, so it is made once)."""
    from dcora_tpu.core import certify as jcert
    from dcora_tpu.parallel import certify as jpar
    from torch_port_common import jax_state

    Pj, _, states = setup
    Xj = jax_state(states["random"])
    lam, _, _ = jpar.minimum_eigen_pair_sharded(
        Pj, jcert.dual_certificate_blocks(Pj, Xj), Xj.dims,
        _mesh(JAX_SHARDS))
    ok, theta, _ = jpar.fast_verification_sharded(
        Pj, jax_state(states["optimum"]), 1e-3, _mesh(JAX_SHARDS))
    return dict(lam=lam, optimum=(ok, theta))


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_min_eig_matches_jax(setup, jax_ref, shards):
    from dcora_tpu_torch.core import certify
    from dcora_tpu_torch.parallel.certify import minimum_eigen_pair_sharded
    from torch_port_common import torch_state

    _, P, states = setup
    X = torch_state(states["random"])
    C = certify.dual_certificate_blocks(P, X)
    lam, v, _ = minimum_eigen_pair_sharded(P, C, X.dims, shards)
    assert lam == pytest.approx(jax_ref["lam"], rel=EIG_RTOL)
    assert v.shape == (X.dims.k,)
    lam_c, _, _ = certify.minimum_eigen_pair(P, C, X.dims)
    assert lam == pytest.approx(lam_c, rel=EIG_RTOL)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_verification_matches_jax(setup, jax_ref, shards):
    from dcora_tpu_torch.parallel.certify import fast_verification_sharded
    from torch_port_common import torch_state

    _, P, states = setup
    ok, theta, _ = fast_verification_sharded(
        P, torch_state(states["optimum"]), 1e-3, shards)
    assert (ok, theta) == jax_ref["optimum"] == (True, 0.0)
    # at the random point the exact Rayleigh quotient of the Ritz vector
    # refutes it: theta is lambda_min
    ok, theta, v = fast_verification_sharded(
        P, torch_state(states["random"]), 1e-3, shards)
    assert not ok and v is not None
    assert theta == pytest.approx(jax_ref["lam"], rel=1e-8)
