"""DC2-PGO on smallGrid3D with 5 robots from the Chordal init at the
driver's defaults, on the CPU, against the JAX package's run on the same
generated file (tests/data/torch_port_robust_reference.json,
"mr_smallGrid3D", written by tests/make_torch_port_reference.py): the same
certified flag, rank and round count, and f* to 1e-8 relative.  The JAX
run is recorded rather than repeated here: the two together take about
two minutes on one CPU core.
"""

import json
import os

import numpy as np
import pytest
import torch

HERE = os.path.dirname(__file__)
REFERENCE = os.path.join(HERE, "data", "torch_port_robust_reference.json")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_multi_robot_pgo_small_grid_matches_jax(tmp_path):
    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.drivers import multi_robot_pgo
    from dcora_tpu_torch.types import InitializationMethod

    with open(REFERENCE) as fh:
        refs = json.load(fh)
    ref = refs["mr_smallGrid3D"]
    kw = dict(ref["kwargs"], shape=tuple(ref["kwargs"]["shape"]))
    path = datasets.generate_grid_g2o(str(tmp_path / "g.g2o"), **kw)
    lifts = refs["lifting_matrices"]
    res = multi_robot_pgo.run(
        ref["robots"], path, init_method=InitializationMethod.Chordal,
        device="cpu", lifting_matrix=lambda r: np.array(lifts[str(r)]))
    assert res.certified == ref["certified"] is True
    assert res.final_rank == ref["rank"]
    assert res.total_iters == ref["total_iters"]
    assert len(res.cost_trace) == ref["rounds"]
    assert res.cost_trace[-1] == pytest.approx(ref["f"], rel=1e-8)
