"""The reference's SE interleaved layout in the port
(``lifted.to_se_matrix`` / ``from_se_matrix``, ``Agent.set_X_matrix``)
against the JAX package's, on seeded states made with numpy: the same
matrix (exactly: the layouts only move values), the round trip back to the
state, and an agent set from a matrix holding the JAX agent's iterate."""

import os

import numpy as np
import pytest
import torch

import dcora_tpu.agent as jagent
import dcora_tpu.types as jtypes
import dcora_tpu_torch.agent as tagent
import dcora_tpu_torch.types as ttypes
from dcora_tpu.core import lifted as jlifted
from dcora_tpu.core import manifold as jmanifold
from dcora_tpu.types import ProblemDims as JDims
from dcora_tpu_torch.core import lifted as tlifted
from torch_port_common import jax_state, np_of, random_state_arrays, \
    torch_state


@pytest.mark.parametrize("d,n,r", [(3, 6, 5), (2, 9, 4), (3, 1, 3)])
def test_se_matrix_values_and_round_trip_match_jax(d, n, r):
    """A pose-only state (l = b = 0), as the JAX test of the layout."""
    arrs = random_state_arrays(np.random.default_rng(n + r),
                               JDims(d, n), r)
    M = tlifted.to_se_matrix(torch_state(arrs))
    Mj = np.asarray(jlifted.to_se_matrix(jax_state(arrs)))
    assert M.shape == (r, (d + 1) * n) and M.dtype == torch.float64
    np.testing.assert_array_equal(np_of(M), Mj)
    X2 = tlifted.from_se_matrix(M, d)
    Xj = jlifted.from_se_matrix(Mj, d)
    for a, b, want in zip(X2, Xj, arrs):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))
        np.testing.assert_array_equal(np_of(a), want)
    assert X2.sph.shape == (0, r)


def test_se_matrix_keeps_poses_of_a_state_with_landmarks():
    """Landmark translations (rows past n) and spheres are left out, as in
    the JAX package; numpy input is taken as it is."""
    arrs = random_state_arrays(np.random.default_rng(3),
                               JDims(3, 5, 2, 4), 4)
    M = tlifted.to_se_matrix(torch_state(arrs))
    np.testing.assert_array_equal(
        np_of(M), np.asarray(jlifted.to_se_matrix(jax_state(arrs))))
    X2 = tlifted.from_se_matrix(np_of(M), 3)
    np.testing.assert_array_equal(np_of(X2.trn), arrs[2][:5])
    np.testing.assert_array_equal(np_of(X2.rot), arrs[0])


def test_agent_set_X_matrix_matches_jax(data_dir):
    """Each engine's agent on robot 0 of tinyGrid3D, read by its own
    parser, set from one SE matrix."""
    from dcora_tpu.io import read_g2o_file as jread
    from dcora_tpu_torch.io import read_g2o_file as tread

    R, D = 5, 3
    path = os.path.join(data_dir, "tinyGrid3D.g2o")
    got = []
    for mod, T, read in ((jagent, jtypes, jread), (tagent, ttypes, tread)):
        ms = [m for m in read(path).pose_pose_measurements
              if m.r1 == m.r2 == 0]
        n = 1 + max(max(m.p1, m.p2) for m in ms)
        arrs = random_state_arrays(np.random.default_rng(8), JDims(D, n), R)
        M = np.asarray(jlifted.to_se_matrix(jax_state(arrs)))
        p = T.AgentParameters(d=D, r=R, robotIDs=frozenset([0]))
        kw = {} if mod is jagent else dict(
            device="cpu",
            lifting_matrix=np.asarray(jmanifold.fixed_lifting_matrix(R, D)))
        a = mod.Agent(0, p, **kw)
        a.set_measurements(ms)
        a.initialize()
        a.set_X_matrix(M)
        assert a.state == T.AgentState.INITIALIZED
        got.append(a.get_X())
    assert got[1].rot.dtype == torch.float64
    for a, b, want in zip(got[1], got[0], arrs):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))
        np.testing.assert_array_equal(np_of(a), want)
