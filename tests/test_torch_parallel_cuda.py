"""The synchronous-parallel RBCD of the port on the card.

  * The batched round (edge path at float64, its tCG replayed as a CUDA
    graph; tiled path at float64 tiles, its tile products through kernel
    1) on the card against the same round on the CPU: the iterate to 1e-9
    of its largest entry (the segment sums' long rows and the SpMM kernel
    sum in other orders on the card, and CG carries that along).
  * Kernel 1 (csrc/spmm_sym.cu) on the stacked strips of 4 agents against
    its plain version spmm_strips_plain: 1e-12 of max|W| in f64, 1e-5 in
    f32 (a different summation order plus f32 rounding).
  * Exactly one launch of kernel 1 per batched tile product of a tiled
    round, and no launch of kernels 2 or 3.
  * The round inside a one-rank NCCL group (a TCP store on localhost)
    bitwise equal to the round with no group, and two rounds with no
    group bitwise equal: the edge path's segment sums are the
    deterministic kernel csrc/segment_sum.cu, so no global switch of
    torch's is needed.

Imports only torch, numpy and the port, so it runs where JAX is not
installed; every test skips without a CUDA device.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py
"""

import os
import socket

import pytest
import torch

pytestmark = pytest.mark.cuda

AGENTS = 4
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
ROUND_RTOL = 1e-9


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """(ParallelRBCDProblem of smallGrid3D in 4 agents, its packed Chordal
    init on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.core import lifted
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.core.init import chordal_initialization
    from dcora_tpu_torch.core.lifted import RAState
    from dcora_tpu_torch.drivers.multi_robot_pgo import (
        partition_measurements,
        robot_slice,
    )
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.parallel.rbcd import build_parallel_problem, \
        pack_states

    data = datasets.ensure_test_datasets(str(tmp_path_factory.mktemp("d")))
    ds = read_g2o_file(os.path.join(data, "smallGrid3D.g2o"))
    ms, n, r = ds.pose_pose_measurements, ds.num_poses, 5
    odo, priv, shared, _ = partition_measurements(ms, n, AGENTS)
    graphs = []
    for a in range(AGENTS):
        g = LocalGraph(a, r, 3)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)
    pp = build_parallel_problem(graphs)
    X = lifted.pad_rank(lifted.from_pose_array(
        chordal_initialization(ms, device="cpu")), r)
    Xb = pack_states(pp, [
        RAState(rot=X.rot[s:e], sph=X.sph[:0], trn=X.trn[s:e])
        for s, e in (robot_slice(n, AGENTS, a) for a in range(AGENTS))])
    return pp, Xb


def _cfg():
    from dcora_tpu_torch.drivers.parallel_pgo import ROUND_CFG

    return ROUND_CFG


@pytest.mark.parametrize("backend", ["edge", "tiled"])
def test_round_on_card_matches_cpu(fleet, backend):
    from dcora_tpu_torch.parallel.rbcd import ParallelRound

    pp, Xb = fleet
    outs = {}
    for dev in ("cpu", "cuda"):
        rnd = ParallelRound(pp, _cfg(), backend=backend,
                            tile_dtype=torch.float64, device=dev)
        X = Xb.to(dev)
        for _ in range(3):
            X, g = rnd(X)
        outs[dev] = (X, g)
    (Xh, gh), (Xc, gc) = outs["cpu"], outs["cuda"]
    assert Xc.rot.is_cuda
    for a, b in zip(Xc, Xh):
        if b.numel():
            assert _rel_err(a.cpu(), b) <= ROUND_RTOL
    assert _rel_err(gc.cpu(), gh) <= ROUND_RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_on_stacked_strips_matches_plain(fleet, dtype):
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.parallel.rbcd import build_stacked_tiled

    pp, _ = fleet
    TP = build_stacked_tiled(pp, 0, AGENTS, dtype, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((8, AGENTS, TP.meta.kpad), generator=gen, dtype=dtype,
                    device="cuda")
    before = spmm.spmm_sym.launches
    W = tiled.apply_tiled(TP, X)
    assert spmm.spmm_sym.launches == before + 1
    plain = spmm.spmm_strips_plain(TP.Q.strips, X.reshape(8, -1))
    torch.cuda.synchronize()
    assert _rel_err(W.reshape(8, -1), plain) <= RTOL[dtype]


def test_one_launch_per_batched_product(fleet):
    from dcora_tpu_torch.core import spmm
    from dcora_tpu_torch.parallel.rbcd import ParallelRound
    from dcora_tpu_torch.tools import common

    pp, Xb = fleet
    rnd = ParallelRound(pp, _cfg(), backend="tiled",
                        tile_dtype=torch.float32, device="cuda")
    # a product recorded in the round's tCG graph counts once per replay,
    # as its launch does
    products, restore = common.count_products()
    try:
        spmm.reset_launches()
        X = Xb.to("cuda")
        for _ in range(3):
            X, _ = rnd(X)
        torch.cuda.synchronize()
        counts = spmm.launch_counts()
    finally:
        restore()
    assert counts["spmm_sym"] == products[0] > 0
    assert counts["spmm_symmetric"] == counts["spmm_paired"] == 0


def test_one_rank_nccl_round_is_bitwise_local(fleet):
    """The tiled round (float32 tiles, the drivers' default on the card),
    with torch's deterministic switch off: in a group and alone, and alone
    twice, bitwise equal."""
    import torch.distributed as dist

    from dcora_tpu_torch.parallel.rbcd import ParallelRound, init_group

    pp, Xb = fleet
    X = Xb.to("cuda")
    kw = dict(backend="tiled", tile_dtype=torch.float32, device="cuda")
    assert not torch.are_deterministic_algorithms_enabled()
    local = ParallelRound(pp, _cfg(), **kw)(X)
    again = ParallelRound(pp, _cfg(), **kw)(X)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    group = init_group("cuda", f"tcp://localhost:{port}", 1, 0)
    try:
        assert dist.get_backend(group) == "nccl"
        in_group = ParallelRound(pp, _cfg(), group=group, **kw)(X)
    finally:
        dist.destroy_process_group()
    for a, b, c in zip(in_group[0], local[0], again[0]):
        assert torch.equal(a, b) and torch.equal(c, b)
    assert torch.equal(in_group[1], local[1])
