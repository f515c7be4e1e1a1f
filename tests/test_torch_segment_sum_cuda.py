"""The deterministic segment-sum kernel (csrc/segment_sum.cu) on the card.

  * Against its plain version (index_add_ per part on the card, whose
    float atomics sum in another order): 1e-5 of max|out| in f32 and 1e-13
    in f64, widths 3, 9 and 27, with empty rows, contributions on the pad
    slot and a row of 5,000 contributions; on every row the kernel gives
    the CPU's bits.
  * Two calls bitwise equal; a captured CUDA graph replayed twice bitwise
    equal to the eager call, its launch counted once per replay.
  * apply_Q raises on a CUDA ProblemData without maps, as on the CPU; the
    edge path's tCG through rtr.TCGGraph counts three launches per
    iteration on an RA problem (per replay, beside the capture's eager
    warm-up), and two 200-iteration solves are bitwise equal.

Imports only torch, numpy and the port, so it runs where JAX is not
installed; every test skips without a CUDA device.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_segment_sum_cuda.py
"""

import numpy as np
import pytest
import torch

from dcora_tpu_torch.core import kernels, segment

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float64: 1e-13}


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _case(w, dtype, seed=0):
    """Three parts over 64 rows (+ the pad slot 64): row 3 takes 5,000
    contributions, rows 5 and 62 none."""
    rng = np.random.default_rng(seed)
    num = 64
    rows = [r for r in range(num + 1) if r not in (5, num - 2)]
    parts = []
    for p, m in enumerate((300, 10_000, 500)):
        idx = rng.choice(rows, m)
        if p == 1:
            idx[rng.permutation(m)[:5000]] = 3
        parts.append((idx,))
    K = 10_800
    contrib = torch.as_tensor(
        rng.standard_normal((K, w)) * 10.0 ** rng.uniform(-3, 3, (K, 1)),
        dtype=dtype)
    return segment.build_map(parts), contrib, num


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w", [3, 9, 27])
def test_kernel_matches_plain_and_repeats(w, dtype):
    m_cpu, c_cpu, num = _case(w, dtype)
    m = m_cpu._replace(perm=m_cpu.perm.cuda(), ptr=m_cpu.ptr.cuda())
    c = c_cpu.cuda()
    before = segment.segment_sum.launches
    out = segment.segment_sum(c, m, num)
    again = segment.segment_sum(c, m, num)
    assert segment.segment_sum.launches == before + 2
    plain = segment.segment_sum_plain(c, m, num)  # index_add_ on the card
    cpu = segment.segment_sum_plain(c_cpu, m_cpu, num)
    torch.cuda.synchronize()
    assert out.is_cuda and out.shape == (num, w) and out.dtype == dtype
    scale = float(plain.abs().max())
    assert float((out - plain).abs().max()) <= RTOL[dtype] * scale
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), cpu)
    assert not out[5].any() and not out[num - 2].any()


def test_graph_replays_bitwise_and_counted():
    m_cpu, c_cpu, num = _case(9, torch.float64, seed=1)
    m = m_cpu._replace(perm=m_cpu.perm.cuda(), ptr=m_cpu.ptr.cuda())
    c = c_cpu.cuda()
    eager = segment.segment_sum(c, m, num)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        segment.segment_sum(c, m, num)  # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kernels.captured_counts()
    with torch.cuda.graph(graph):
        static = segment.segment_sum(c, m, num)
    per = {k: v - before[k] for k, v in kernels.captured_counts().items()}
    assert per["segment_sum"] == 1
    launches = segment.segment_sum.launches
    outs = []
    for _ in range(2):
        static.zero_()
        graph.replay()
        kernels.add_replays(per)
        outs.append(static.clone())
    torch.cuda.synchronize()
    assert segment.segment_sum.launches == launches + 2
    assert all(torch.equal(o, eager) for o in outs)


@pytest.fixture(scope="module")
def ra(tmp_path_factory):
    from dcora_tpu_torch.tools import common

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = common.ra_set(str(tmp_path_factory.mktemp("ra")), 20)
    return path, common.load_graph(path, 3)


def test_apply_Q_needs_maps_on_the_card(ra):
    from dcora_tpu_torch.core import lifted, problem as prob

    _, g = ra
    P = g.problem_data(device="cuda")
    X = lifted.zeros(g.dims, 3).to("cuda")
    prob.apply_Q(P, X)
    with pytest.raises(ValueError, match="segment maps"):
        prob.apply_Q(P._replace(seg=None), X)


def test_tcg_graph_counts_per_replay_and_repeats(ra):
    from dcora_tpu_torch.core import rtr
    from dcora_tpu_torch.tools import common

    path, _ = ra
    tcg = common.edge_tcg(path, 3, 200)
    graph = tcg.graph
    runs = []
    for _ in range(2):
        before = segment.segment_sum.launches
        res = tcg.solve()
        runs.append((res, segment.segment_sum.launches - before))
    torch.cuda.synchronize()
    # one apply_Q (three blocks: rotations, translations, spheres) per
    # iteration, STEPS iterations per replay
    assert graph.per_replay["segment_sum"] == 3 * rtr.TCGGraph.STEPS
    (a, na), (b, nb) = runs
    assert int(a.inner_iters) == int(b.inner_iters) == 200
    # the first solve also runs the capture's eager warm-up (STEPS
    # iterations) once
    per = graph.per_replay["segment_sum"]
    assert nb > 0 and nb % per == 0 and na == nb + per
    for x, y in ((a.eta, b.eta), (a.Heta, b.Heta)):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
