"""A run of each cell at a test's size on the card: the same comparison,
through the port's kernels.  Marked cuda; skips without a card (decided
in a fixture, not at import)."""

import pytest

from port_bench import harness
from port_bench.tests.conftest import small_cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["grid3d.certify", "grid3d.tiles"])
def test_small_cell_on_the_card(card, workload, tmp_path):
    import time

    out = harness.run_cell(small_cell(workload), 2147483700, 0.5, False,
                           card, str(tmp_path), time.perf_counter(),
                           log=lambda s: None)
    assert out["correct"], out["checks"]
