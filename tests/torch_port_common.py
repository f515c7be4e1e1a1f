"""Shared helpers for the port-vs-reference tests (tests/test_torch_*.py).

Inputs are made from a seed with numpy and fed to both engines: the JAX
package (dcora_tpu) and the PyTorch port (dcora_tpu_torch, through
dcora_tpu_torch.convert).  Tolerances:

  * F64_RTOL: f64 operators agree to 1e-10 relative (the port's bar);
  * F32_ATOL: the f32 tile path agrees to 2e-6 of max|W| (the bar of
    tests/test_tiled.py for the Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

import dcora_tpu.core.graph as jgraph
import dcora_tpu.measurements as jmeas
import dcora_tpu.types as jtypes
import dcora_tpu_torch.core.graph as tgraph
import dcora_tpu_torch.measurements as tmeas
import dcora_tpu_torch.types as ttypes
from dcora_tpu.datasets import _rand_rotation

F64_RTOL = 1e-10
F32_ATOL = 2e-6


def np_of(x) -> np.ndarray:
    """Host float64/int array of a jax array, torch tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(a, b, rtol=F64_RTOL, scale=None):
    """|a - b| <= rtol * max(|b|) elementwise (scale-relative)."""
    a, b = np_of(a), np_of(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    s = scale if scale is not None else max(float(np.abs(b).max(initial=0)),
                                            1e-300)
    err = float(np.abs(a - b).max(initial=0)) / s
    assert err <= rtol, f"relative error {err:.3e} > {rtol:.1e}"


def assert_state_close(A, B, rtol=F64_RTOL):
    scale = max(float(np.abs(np_of(x)).max(initial=0)) for x in B)
    for a, b in zip(A, B):
        assert_close(a, b, rtol, scale=max(scale, 1e-300))


def random_graph_spec(rng, n=7, l=4, b=3, d=3):  # noqa: E741
    """A measurement list with every type, random weights, as plain dicts
    (the tests/test_tiled.py:32-61 graph, drawn with numpy only)."""
    spec = []
    for i in range(n - 1):
        spec.append(("pp", dict(r1=0, p1=i, r2=0, p2=i + 1,
                                R=_rand_rotation(rng, np.pi),
                                t=rng.standard_normal(d),
                                kappa=rng.uniform(1, 5),
                                tau=rng.uniform(1, 5),
                                weight=rng.uniform(0.3, 1.0))))
    for _ in range(2):  # loop closures
        i, j = sorted(rng.choice(n, size=2, replace=False))
        if j > i + 1:
            spec.append(("pp", dict(r1=0, p1=int(i), r2=0, p2=int(j),
                                    R=_rand_rotation(rng, np.pi),
                                    t=rng.standard_normal(d),
                                    kappa=rng.uniform(1, 5),
                                    tau=rng.uniform(1, 5),
                                    weight=rng.uniform(0.3, 1.0))))
    for j in range(b):
        spec.append(("pl", dict(r1=0, p1=int(rng.integers(n)), r2=0, p2=j,
                                t=rng.standard_normal(d),
                                tau=rng.uniform(1, 5),
                                weight=rng.uniform(0.3, 1.0))))
    for q in range(l):
        i = int(rng.integers(n))
        j = int(rng.integers(b)) if b else int(rng.integers(n))
        spec.append(("rg", dict(r1=0, p1=i, r2=0, p2=j,
                                land=bool(b), l=q,
                                range=float(rng.uniform(0.5, 3.0)),
                                precision=rng.uniform(1, 5),
                                weight=rng.uniform(0.3, 1.0))))
    return spec


def _measurements(spec, M, Ty):
    out = []
    for kind, kw in spec:
        kw = dict(kw)
        if kind == "pp":
            out.append(M.RelativePosePoseMeasurement(**kw))
        elif kind == "pl":
            out.append(M.RelativePoseLandmarkMeasurement(**kw))
        else:
            land = kw.pop("land")
            st2 = Ty.StateType.Landmark if land else Ty.StateType.Pose
            out.append(M.RangeMeasurement(
                kw["r1"], kw["p1"], kw["r2"], kw["p2"], Ty.StateType.Pose,
                st2, kw["l"], kw["range"], precision=kw["precision"],
                weight=kw["weight"]))
    return out


def build_graphs(spec, d=3, r=None, prior=True):
    """(JAX LocalGraph, port LocalGraph) over the same measurements, each
    with the same pose-0 prior."""
    r = d if r is None else r
    graphs = []
    for G, M, Ty in ((jgraph, jmeas, jtypes), (tgraph, tmeas, ttypes)):
        g = G.LocalGraph(0, r, d)
        g.set_measurements(_measurements(spec, M, Ty))
        if prior:
            P0 = np.zeros((r, d + 1))
            P0[:d, :d] = np.eye(d)
            g.set_prior(0, P0)
        graphs.append(g)
    return graphs


def random_state_arrays(rng, dims, r):
    """(rot, sph, trn) numpy arrays of a random point on the manifold."""
    A = rng.standard_normal((dims.n, r, dims.d))
    U, _, Vt = np.linalg.svd(A, full_matrices=False)
    rot = U @ Vt
    sph = rng.standard_normal((dims.l, r))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    trn = rng.standard_normal((dims.num_trans, r))
    return rot, sph, trn


def jax_state(arrs):
    import jax.numpy as jnp
    from dcora_tpu.core.lifted import RAState

    return RAState(*(jnp.asarray(a) for a in arrs))


def torch_state(arrs, device="cpu"):
    from dcora_tpu_torch.core.lifted import RAState

    return RAState(*(torch.as_tensor(a, dtype=torch.float64, device=device)
                     for a in arrs))
