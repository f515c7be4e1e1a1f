"""The block-tridiagonal (BTD) preconditioner solve of the PyTorch port
against the JAX package's, on the CPU.

A band of nt 128 x 128 blocks (SPD diagonal blocks, random sub-diagonal
blocks, one of them zero at nt = 7, as where _factor_btd finds the band
broken) is made from a seed with numpy and factored by each package's own
_factor_btd; both factors must agree, and the port's plain solve
(tiled._precondition_btd) must give JAX's (the two lax.scans of
dcora_tpu/core/tiled.py:822) on the same V: 1e-12 of max|Y| in f64, 1e-5
in f32 (another summation order, over 2 nt - 1 dependent products).  The
wrapper btd_solve, which launches csrc/btd_solve.cu on the card, runs the
plain loop on CPU tensors bit for bit, counts no launch there, and refuses
what its kernel does not take on either device.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcora_tpu.core.tiled as jtiled
import dcora_tpu_torch.core.tiled as ttiled
from torch_port_common import assert_close

T = 128
REG = 0.1
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _band(nt: int, seed: int):
    """The stored tiles of a block-tridiagonal Q (both triangles, as
    build_tiled hands them to _factor_btd): (dense, trow, tcol)."""
    rng = np.random.default_rng(seed)
    dense, trow, tcol = [], [], []
    for i in range(nt):
        A = rng.standard_normal((T, T)) / np.sqrt(T)
        dense.append(A @ A.T + np.eye(T))
        trow.append(i)
        tcol.append(i)
        if i == 0:
            continue
        L = 0.4 * rng.standard_normal((T, T)) / np.sqrt(T)
        if nt >= 3 and i == nt // 2:
            L[:] = 0.0  # a broken band: L~_i is exactly zero
        dense += [L, L.T]
        trow += [i, i - 1]
        tcol += [i - 1, i]
    return np.stack(dense), np.array(trow), np.array(tcol)


def _problems(nt: int, dtype, seed: int = 0):
    """A port TiledProblem stand-in and a JAX one over the same band, each
    factored by its own package."""
    dense, trow, tcol = _band(nt, seed)
    Lt, Sinv = ttiled._factor_btd(dense, trow, tcol, nt, T, REG)
    jdt = np.float32 if dtype == torch.float32 else np.float64
    Ltj, Sinvj = jtiled._factor_btd(dense, trow, tcol, nt, T, REG, jdt)
    np.testing.assert_array_equal(np.asarray(Ltj), Lt.astype(jdt))
    np.testing.assert_array_equal(np.asarray(Sinvj), Sinv.astype(jdt))
    meta = ttiled.TiledMeta(d=3, n=0, l=0, b=0, T=T, nt=nt)
    TPt = types.SimpleNamespace(
        meta=meta, btd_ltil=torch.as_tensor(Lt, dtype=dtype),
        btd_sinv=torch.as_tensor(Sinv, dtype=dtype), btd_layout=None)
    TPj = types.SimpleNamespace(meta=meta, btd_ltil=Ltj, btd_sinv=Sinvj)
    return TPt, TPj


def _v(r_pad: int, nt: int, dtype, seed: int = 1):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (r_pad, nt * T)), dtype=dtype)


@pytest.mark.parametrize("nt", [1, 2, 7])
@pytest.mark.parametrize("r_pad", [8, 16, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_solve_matches_jax(dtype, r_pad, nt):
    TPt, TPj = _problems(nt, dtype)
    V = _v(r_pad, nt, dtype, seed=r_pad + nt)
    Y = ttiled._precondition_btd(TPt, V)
    Yj = jtiled._precondition_btd(TPj, jnp.asarray(V.numpy()))
    assert Y.dtype == dtype and Y.shape == V.shape
    assert np.asarray(Yj).dtype == V.numpy().dtype
    assert bool(torch.isfinite(Y).all())
    assert_close(Y, Yj, rtol=RTOL[dtype])


@pytest.mark.parametrize("nt", [1, 2, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_on_cpu_is_the_plain_loop(dtype, nt):
    """btd_solve and precondition_flat on CPU tensors: the plain loop's
    bits, a new tensor, no launch counted, no panel layout made."""
    TPt, _ = _problems(nt, dtype, seed=2)
    V = _v(16, nt, dtype)
    before = ttiled.btd_solve.launches
    for fn in (ttiled.btd_solve, ttiled.precondition_flat):
        Y = fn(TPt, V)
        assert torch.equal(Y, ttiled._precondition_btd(TPt, V))
        assert Y.data_ptr() != V.data_ptr()
    assert ttiled.btd_solve.launches == before
    assert TPt.btd_layout is None


@pytest.mark.parametrize("bad", ["dtype", "kpad", "r_pad", "strided"])
def test_wrapper_refuses(bad):
    TPt, _ = _problems(2, torch.float64, seed=3)
    V = _v(8, 2, torch.float64)
    V = {"dtype": V.float(),
         "kpad": V[:, :T].contiguous(),
         "r_pad": V[:6].contiguous(),
         "strided": torch.cat([V, V]).view(8, 2, 2 * T)[:, 0]}[bad]
    with pytest.raises((TypeError, ValueError)):
        ttiled.btd_solve(TPt, V)
    with pytest.raises((TypeError, ValueError)):
        ttiled.precondition_flat(TPt, V)
