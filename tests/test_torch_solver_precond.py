"""rtr_fast of the PyTorch port under the DCORA_RA_PRECOND /
DCORA_PGO_PRECOND overrides (dcora_tpu/solvers.py:150-170) against the JAX
package's, on the generated smallGrid3D set and a small generated RA-SLAM
set: the same tile preconditioner reaches build_tiled and both solves
reach the tolerance at the same f.  (The override table itself:
tests/test_torch_solver_options.py.)"""

import numpy as np
import pytest
import torch

import dcora_tpu.core.rtr as jrtr
import dcora_tpu.core.tiled as jtiled
import dcora_tpu.solvers as jsolvers
import dcora_tpu_torch.core.rtr as trtr
import dcora_tpu_torch.core.tiled as ttiled
from dcora_tpu_torch import solvers as tsolvers
from test_torch_solver_options import _graphs, sets  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's solver loops issue tiny ops, which a thread pool beside
    the other test workers slows down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind,env", [("pgo", ("DCORA_PGO_PRECOND", "btd")),
                                      ("ra", ("DCORA_RA_PRECOND", "tile"))])
def test_rtr_fast_under_override_matches_jax(sets, monkeypatch, kind, env):
    """rtr_fast in both engines under the same override: the same tile
    preconditioner reaches build_tiled, and both solves reach the
    tolerance at the same f (1e-8)."""
    monkeypatch.setenv(*env)
    gj, gt, Xj, Xt = _graphs(kind, sets[kind])
    modes = {}
    for name, mod in (("jax", jtiled), ("port", ttiled)):
        real = mod.build_tiled

        def spy(*a, real=real, name=name, **kw):
            modes.setdefault(name, set()).add(kw.get("tile_precond"))
            return real(*a, **kw)

        monkeypatch.setattr(mod, "build_tiled", spy)
    cfg = dict(gradnorm_tol=1e-5, max_outer=200, max_inner=100)
    Pj = gj.problem_data()
    rj, _ = jsolvers.rtr_fast(gj, Pj, jsolvers.make_preconditioner(gj, Pj),
                              Xj, jrtr.RTRConfig(**cfg))
    Pt = gt.problem_data(device="cpu")
    rt, _ = tsolvers.rtr_fast(gt, Pt, tsolvers.make_preconditioner(gt, Pt),
                              Xt, trtr.RTRConfig(**cfg))
    assert modes["port"] == modes["jax"] and len(modes["port"]) == 1
    assert float(rj.gradnorm_final) < 1e-5 and float(rt.gradnorm_final) < 1e-5
    np.testing.assert_allclose(float(rt.f_final), float(rj.f_final),
                               rtol=1e-8, atol=1e-10)
