"""The edge path's segment sums (dcora_tpu_torch.core.segment, the CPU side
of csrc/segment_sum.cu) and the segment maps that every ProblemData of the
port carries.

  * the CSR maps plus the plain sum are bitwise equal to index_add_ (one
    per part, the parts' sums added in order, as the port summed before):
    empty rows, contributions on the pad slot, one row of 5,000
    contributions, widths 3, 9 and 27, f32 and f64; a numpy walk of the
    CSR in the kernel's order gives the same bits on every row;
  * apply_Q with maps, on generated PGO and RA sets, against the JAX
    package's apply_Q at the parity tests' 1e-10 (F64_RTOL);
  * after each site that rebuilds index fields (an agent's restricted
    problem, the fleet, a shard, the batched agents' problems, the JAX
    problem carried across) the maps equal a fresh with_segments, and GNC's
    weight change keeps them;
  * DC2-PGO's per-robot sums and the graph-replay launch bookkeeping;
  * segment_sums (up to three blocks, one launch on the card) on the CPU:
    each block's output bitwise equal to its plain sum alone, in f32 and
    f64, one to three blocks; more than three or none are refused;
    apply_Q's three blocks through it give the per-block sums' bits.
"""

import os

import numpy as np
import pytest
import torch

import dcora_tpu.core.problem as jprob
import dcora_tpu.datasets as jds
import dcora_tpu.io as jio
from dcora_tpu.core.graph import LocalGraph as JGraph
from dcora_tpu.io.remap import get_global_measurements as jglobal
from dcora_tpu.types import GraphType as JGraphType
from dcora_tpu_torch import convert
from dcora_tpu_torch.core import problem as tprob
from dcora_tpu_torch.core import kernels, segment, spmm
from dcora_tpu_torch.core.graph import LocalGraph as TGraph
from dcora_tpu_torch.io import read_g2o_file, read_pyfg_file
from dcora_tpu_torch.io.remap import get_global_measurements as tglobal
from dcora_tpu_torch.types import GraphType as TGraphType
from torch_port_common import (
    assert_segments_equal,
    assert_state_close,
    jax_state,
    parallel_pgo_graphs,
    random_state_arrays,
    torch_state,
)

LONG_ROW = 5000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(w, dtype, seed=0):
    """Three parts over `num` rows: row 3 takes LONG_ROW contributions,
    rows 5 and num - 2 none, and some land on the pad slot (== num)."""
    rng = np.random.default_rng(seed)
    num = 64
    rows = [r for r in range(num + 1) if r not in (5, num - 2)]
    lens = (300, 2 * LONG_ROW, 500)
    parts = []
    for p, m in enumerate(lens):
        idx = rng.choice(rows, m)
        if p == 1:
            idx[rng.permutation(m)[:LONG_ROW]] = 3
        parts.append(idx)
    K = sum(lens)
    contrib = torch.as_tensor(
        rng.standard_normal((K, w)) * 10.0 ** rng.uniform(-3, 3, (K, 1)),
        dtype=dtype)
    return parts, contrib, num


def _index_add_per_part(parts, contrib, num):
    """The port's sum before the maps: per part zeros(num + 1).index_add_
    over the raw index array, the parts' sums added in order."""
    out = torch.zeros((num,) + contrib.shape[1:], dtype=contrib.dtype)
    lo = 0
    for idx in parts:
        hi = lo + len(idx)
        s = torch.zeros((num + 1,) + contrib.shape[1:], dtype=contrib.dtype)
        s.index_add_(0, torch.as_tensor(idx), contrib[lo:hi])
        out = out + s[:num]
        lo = hi
    return out


def _kernel_walk(contrib, m, num):
    """csrc/segment_sum.cu in numpy: every row summed in ascending CSR
    order, each part from zero, the parts' sums added in order."""
    c = contrib.numpy()
    perm, ptr = m.perm.numpy(), m.ptr.numpy()
    b1, b2 = m.bounds
    out = np.zeros((num,) + c.shape[1:], c.dtype)
    for row in range(min(num, m.nseg)):
        acc = np.zeros(c.shape[1:], c.dtype)
        part, cur = np.zeros(c.shape[1:], c.dtype), 0
        for k in range(ptr[row], ptr[row + 1]):
            src = perm[k]
            p = int(src >= b1) + int(src >= b2)
            if p != cur:
                acc, part, cur = acc + part, np.zeros_like(part), p
            part = part + c[src]
        out[row] = acc + part
    return torch.as_tensor(out)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w", [3, 9, 27])
def test_maps_and_plain_sum_are_index_add_bitwise(w, dtype):
    parts, contrib, num = _case(w, dtype)
    m = segment.build_map([(p,) for p in parts])
    ref = _index_add_per_part(parts, contrib, num)
    out = segment.segment_sum(contrib, m, num)
    assert out.shape == (num, w) and out.dtype == dtype
    assert torch.equal(out, ref)
    assert torch.equal(segment.segment_sum_plain(contrib, m, num), ref)
    # the CSR walked in the kernel's order, on every row: row 3's 5,000
    # entries too, and the pad slot's (== num) are not written
    assert int(m.ptr[4] - m.ptr[3]) >= LONG_ROW and m.nseg == num + 1
    assert torch.equal(_kernel_walk(contrib, m, num), ref)
    for row in (5, num - 2):
        assert not out[row].any()


def test_map_layout():
    parts = [np.array([4, 1, 4, 0]), np.array([1, 4]), np.array([], int)]
    m = segment.build_map([(parts[0][:2], parts[0][2:]), (parts[1],),
                           (parts[2],)])
    assert m.idx.tolist() == [4, 1, 4, 0, 1, 4]
    assert m.perm.dtype == m.ptr.dtype == torch.int32
    assert m.idx.dtype == torch.int64 and m.idx.device.type == "cpu"
    assert m.perm.tolist() == [3, 1, 4, 0, 2, 5]  # stable: ascending position
    assert m.ptr.tolist() == [0, 1, 3, 3, 3, 6] and m.nseg == 5
    assert m.bounds == (4, 6)
    # more rows asked than the index reaches: zeros past nseg
    c = torch.arange(6.0)[:, None].repeat(1, 2)
    out = segment.segment_sum(c, m, 8)
    assert out[:, 0].tolist() == [3.0, 1 + 4, 0, 0, 0 + 2 + 5, 0, 0, 0]
    empty = segment.build_map([([],)])
    assert empty.nseg == 0 and empty.bounds == (0, 0)
    assert segment.segment_sum(torch.zeros((0, 3)), empty, 4).shape == (4, 3)
    with pytest.raises(ValueError):
        segment.build_map([([0, -1],)])
    with pytest.raises(ValueError):
        segment.segment_sum(torch.zeros((5, 2)), m, 3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nblocks", [1, 2, 3])
def test_segment_sums_blocks_bitwise_per_block(nblocks, dtype):
    """Blocks of other widths, rows and trailing shapes summed together:
    each output is the per-block plain sum's bits (the kernel's grid walks
    the blocks back to back, each row as it would alone)."""
    blocks, want = [], []
    for i, (w, shape) in enumerate(((9, (3, 3)), (3, (3,)), (27, (27,)))
                                   [:nblocks]):
        parts, contrib, num = _case(w, dtype, seed=10 + i)
        m = segment.build_map([(p,) for p in parts])
        c = contrib.reshape((contrib.shape[0],) + shape)
        blocks.append((c, m, num - i))
        want.append(segment.segment_sum_plain(c, m, num - i))
    outs = segment.segment_sums(blocks)
    assert len(outs) == nblocks
    for out, ref, (c, _, num) in zip(outs, want, blocks):
        assert out.shape == (num,) + c.shape[1:] and out.dtype == dtype
        assert torch.equal(out, ref)


def test_segment_sums_refuses_no_or_four_blocks():
    parts, contrib, num = _case(3, torch.float64)
    m = segment.build_map([(p,) for p in parts])
    for blocks in ([], [(contrib, m, num)] * 4):
        with pytest.raises(ValueError, match="1 to 3 blocks"):
            segment.segment_sums(blocks)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """A generated grid (PGO) and a generated PyFG set (RA), each read and
    built by both engines; the port's ProblemData from its own graph."""
    tmp = tmp_path_factory.mktemp("seg")
    g2o = jds.generate_grid_g2o(str(tmp / "grid.g2o"), shape=(4, 4, 3),
                                rot_noise=0.05, trans_noise=0.05, seed=5)
    pyfg = jds.generate_ra_slam_pyfg(str(tmp / "ra.pyfg"), num_robots=3,
                                     poses_per_robot=15, num_landmarks=2,
                                     range_prob=0.8, seed=4)
    out = {}
    gj, gt = JGraph(0, 5, 3), TGraph(0, 5, 3)
    gj.set_measurements(jio.read_g2o_file(g2o).pose_pose_measurements)
    gt.set_measurements(read_g2o_file(g2o).pose_pose_measurements)
    out["pgo"] = (gj, gt)
    gj = JGraph(0, 3, 3, JGraphType.RangeAidedSLAMGraph)
    gt = TGraph(0, 3, 3, TGraphType.RangeAidedSLAMGraph)
    gj.set_measurements(jglobal(jio.read_pyfg_file(pyfg)).relative_measurements)
    gt.set_measurements(tglobal(read_pyfg_file(pyfg)).relative_measurements)
    out["ra"] = (gj, gt)
    out["paths"] = (g2o, pyfg)
    return out


def _fresh(P):
    """The maps a fresh with_segments builds from P's index fields."""
    return tprob.with_segments(P._replace(seg=None)).seg


@pytest.mark.parametrize("kind", ["pgo", "ra"])
def test_apply_Q_with_maps_matches_jax(sets, kind):
    gj, gt = sets[kind]
    Pt = gt.problem_data()
    assert Pt.seg is not None
    assert_segments_equal(Pt.seg, _fresh(Pt))
    arrs = random_state_arrays(np.random.default_rng(7), gj.dims, gj.r)
    ref = jprob.apply_Q(gj.problem_data(), jax_state(arrs))
    out = tprob.apply_Q(Pt, torch_state(arrs))
    assert_state_close(out, ref)
    # the one call of segment_sums gives each block's own sum's bits (no
    # prior term is added on these sets)
    X = torch_state(arrs)
    assert Pt.prior_kdiag is None and Pt.prior_tdiag is None
    for got, c, m, num in zip(
            (out.rot, out.trn, out.sph), tprob.edge_contributions(Pt, X),
            Pt.seg, (X.rot.shape[0], X.trn.shape[0], X.sph.shape[0])):
        assert torch.equal(got, segment.segment_sum_plain(c, m, num))
    with pytest.raises(ValueError, match="segment maps"):
        tprob.apply_Q(Pt._replace(seg=None), torch_state(arrs))


def test_maps_rebuilt_by_agents_fleet_and_batch(data_dir):
    from dcora_tpu_torch.agent import pad_problem_for_local
    from dcora_tpu_torch.parallel.rbcd import (
        build_parallel_problem,
        fleet_operator,
    )

    graphs = parallel_pgo_graphs("torch",
                                 os.path.join(data_dir, "smallGrid3D.g2o"))
    moved = 0
    for g in graphs:
        P = g.problem_data()
        Ploc = pad_problem_for_local(P, g)  # the agent's restricted problem
        moved += not all(torch.equal(getattr(Ploc, f), getattr(P, f))
                         for f in tprob._INDEX_FIELDS)
        assert_segments_equal(Ploc.seg, _fresh(Ploc))
    assert moved  # fixed slots were clamped onto the pad slot
    pp = build_parallel_problem(graphs)
    assert pp.P.seg is None and pp.P_loc.seg is None  # [A, m] stacks
    for Pst, extra in ((pp.P, (pp.fp_max, pp.ft_max, pp.fs_max)),
                       (pp.P_loc, (0, 0, 0))):
        strides = (pp.n_max + extra[0] + 1, pp.t_max + extra[1] + 1,
                   pp.l_max + extra[2] + 1)
        Pf = fleet_operator(Pst, 0, pp.num_agents, strides, "cpu")
        assert_segments_equal(Pf.seg, _fresh(Pf))
    # GNC changes only the weights: the maps stay those of the indices
    Pw = Pf._replace(pp_w=torch.rand_like(Pf.pp_w))
    assert_segments_equal(Pw.seg, _fresh(Pw))


def test_maps_rebuilt_by_shards_and_convert(sets):
    from dcora_tpu_torch.parallel.certify import (
        _shards_of,
        shard_problem_edges,
    )

    gj, gt = sets["ra"]
    P = gt.problem_data()
    P_sh = shard_problem_edges(P, 4)
    assert P_sh.seg is None  # [A, chunk] fields: no maps of their own
    for lo, hi in ((0, 4), (1, 3)):
        Ps = _shards_of(P_sh, lo, hi)
        assert_segments_equal(Ps.seg, _fresh(Ps))
    Pc = convert.problem_data(gj.problem_data())
    assert_segments_equal(Pc.seg, _fresh(Pc))
    assert_segments_equal(Pc.seg, P.seg)


def test_stacked_tiled_agents_get_maps(data_dir, monkeypatch):
    """build_stacked_tiled and build_parallel_problem hand each agent's
    ProblemData, with its maps, to the host builders."""
    from dcora_tpu_torch.core import tiled
    from dcora_tpu_torch.parallel import rbcd

    graphs = parallel_pgo_graphs("torch",
                                 os.path.join(data_dir, "smallGrid3D.g2o"))
    seen = []
    real = tiled.build_tiled

    def spy(P, *a, **k):
        seen.append(P)
        return real(P, *a, **k)

    monkeypatch.setattr(tiled, "build_tiled", spy)
    pp = rbcd.build_parallel_problem(graphs)
    rbcd.build_stacked_tiled(pp, 0, pp.num_agents)
    assert len(seen) == pp.num_agents
    for P in seen:
        assert_segments_equal(P.seg, _fresh(P))


def test_central_eval_per_robot_sums(sets):
    from dcora_tpu_torch.drivers.multi_robot_pgo import central_eval

    _, gt = sets["pgo"]
    P = gt.problem_data()
    arrs = random_state_arrays(np.random.default_rng(2), gt.dims, gt.r)
    X = torch_state(arrs)
    n, robots = gt.n, 5
    ids = [min(i // (n // robots), robots - 1) for i in range(n)]
    f, gn, blocks = central_eval(P, None, X, segment.build_map([(ids,)]),
                                 robots)
    from dcora_tpu_torch.core.rtr import riemannian_gradient

    G = riemannian_gradient(P, X, None)
    sq = (G.rot ** 2).sum(dim=(1, 2)) + (G.trn ** 2).sum(dim=1)
    want = torch.zeros(robots, dtype=sq.dtype).index_add_(
        0, torch.as_tensor(ids), sq).sqrt()
    assert blocks == want.tolist()
    assert f == float(tprob.cost(P, X)) and gn == float(G.norm())


def test_graph_replays_count_their_launches(monkeypatch):
    """Launches recorded in a CUDA graph count once per replay
    (rtr.TCGGraph), on top of the eager ones."""
    fn = segment.segment_sum
    launches, captured = fn.launches, fn.captured
    try:
        capturing = [True]
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: capturing[0])
        before = kernels.captured_counts()
        for _ in range(3):  # a capture recording three launches
            kernels.count_launch(fn)
        capturing[0] = False
        per = {k: v - before[k] for k, v in kernels.captured_counts().items()}
        assert per == dict(spmm_sym=0, spmm_symmetric=0, spmm_paired=0,
                           segment_sum=3, btd_solve=0, flat_rhess=0,
                           flat_precond=0, ldlt=0)
        spmm.reset_launches()
        kernels.count_launch(fn)  # an eager launch
        for _ in range(3):
            kernels.add_replays(per)
        assert spmm.launch_counts()["segment_sum"] == 10
        assert spmm.launch_counts()["spmm_sym"] == 0
    finally:
        fn.launches, fn.captured = launches, captured
