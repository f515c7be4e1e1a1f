"""The flat layout's per-pose ops on the card: the two kernels of
dcora_tpu_torch/csrc/flat_ops.cu (flat_rhess, flat_precond) against their
plain versions, and the flat tCG replayed as a CUDA graph against its
iterations issued one by one.

Imports only torch, numpy and the port, so it runs where JAX is not
installed; every test skips without a CUDA device.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_flat_ops_cuda.py

Problems: a 216-pose grid (per-pose Jacobi, the PGO tile phases') and a
200-pose RA set with 85 unit spheres and 4 landmarks (BTD, as the RA tile
phases), at rank 5 with zero rows up to r_pad; and layouts that fill no
tile of the kernels evenly (d = 2 and 3, n no multiple of a tile's 16
poses, spheres, landmarks, stacks of 3 agents) with random operands, at
r_pad 8, 16 and 24 (more rows than one staged chunk), also one element
off 16-byte alignment.  Tolerances relative to the plain version's max:
1e-12 in f64 and 1e-5 in f32.  On the grid, and on the pose blocks of
every layout, the kernels give the plain version's bits: they take every
per-pose sum in the order of the plain version's batched products; the
sphere columns' sums are taken in another order.  Two launches, and the
graph and the eager loop, give the same bits: the kernels use no atomics
and the graph records the same launches.
"""

import dataclasses
import types

import pytest
import torch

from dcora_tpu_torch import datasets
from dcora_tpu_torch.core import kernels, manifold, rtr, tiled
from dcora_tpu_torch.solvers import make_preconditioner, precond_reg
from dcora_tpu_torch.tools import common

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
RANK = 5


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = tmp_path_factory.mktemp("flat")
    grid = datasets.generate_grid_g2o(str(d / "g216.g2o"), shape=(6, 6, 6),
                                      seed=5)
    ra = datasets.generate_ra_slam_pyfg(
        str(d / "ra200.pyfg"), num_robots=5, poses_per_robot=40,
        num_landmarks=4, range_prob=0.5, rot_noise=0.05, trans_noise=0.02,
        range_noise=0.02, seed=3)
    return {"grid": common.load_graph(grid, RANK),
            "ra": common.load_graph(ra, RANK)}


def _problem(g, dtype, device="cuda"):
    """The tiles as the tile phases build them: per-pose Jacobi on the
    grid, BTD on the RA set."""
    P = g.problem_data(device=device)
    M = make_preconditioner(g, P)
    ra = g.l > 0
    return tiled.build_tiled(P, g.dims, dtype=dtype, precond=M,
                             reg=precond_reg(g, P) if ra else 0.1,
                             tile_precond="btd" if ra else False)


def _flat(TP, g, r_pad, seed):
    """X on the manifold at rank 5 and V, eta with zero rows past it."""
    gen = torch.Generator().manual_seed(seed)
    X = tiled.to_flat(TP, manifold.random_state(g.dims, RANK, gen).to(
        TP.device), r_pad=r_pad).to(TP.dtype)
    out = [X]
    for _ in range(2):
        V = torch.randn(X.shape, generator=gen, dtype=torch.float64)
        V[RANK:] = 0.0
        out.append(V.to(device=TP.device, dtype=TP.dtype))
    return out


@pytest.mark.parametrize("r_pad", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["grid", "ra"])
def test_kernels_match_plain(graphs, name, dtype, r_pad):
    g = graphs[name]
    TP = _problem(g, dtype)
    meta = TP.meta
    X, V, E = _flat(TP, g, r_pad, seed=r_pad)
    tol = RTOL[dtype]
    before = kernels.launch_counts()
    aux = tiled.weingarten_setup(meta, X, tiled.egrad_flat(TP, X))
    aux_p = tiled._weingarten_setup_plain(meta, X, tiled.egrad_flat(TP, X))
    assert _rel_err(aux[0], aux_p[0]) <= tol
    if meta.l:
        assert _rel_err(aux[1], aux_p[1]) <= tol
    HV = tiled.apply_tiled(TP, E)
    pairs = {
        "tangent": (lambda: tiled.tangent_project_flat(meta, X, V),
                    lambda: tiled._tangent_project_plain(meta, X, V)),
        "rhess": (lambda: tiled.flat_rhess(meta, X, HV, E, aux),
                  lambda: tiled._rhess_plain(meta, X, HV, E, aux)),
        "hess": (lambda: tiled.flat_rhess(meta, None, HV, E, aux,
                                          project=False),
                 lambda: tiled._rhess_plain(meta, None, HV, E, aux,
                                            project=False)),
    }
    if name == "grid":
        pairs["precond"] = (
            lambda: tiled.flat_precond(TP, X, V),
            lambda: tiled._tangent_project_plain(
                meta, X, tiled._precondition_pose_plain(TP, V)))
    for what, (kern, plain) in pairs.items():
        out, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()), what
        assert _rel_err(out, ref) <= tol, what
        assert torch.equal(out, again), what
        assert not out[RANK:].any(), what
        if name == "grid":  # poses alone: the plain version's bits
            assert torch.equal(out, ref), what
    after = kernels.launch_counts()
    # weingarten_setup's launch, then two of each of the three pairs
    assert after["flat_rhess"] - before["flat_rhess"] == 1 + 2 * 3
    assert after["flat_precond"] - before["flat_precond"] == \
        (2 if name == "grid" else 0)


# Layouts the kernels tile unevenly: (d, n, l, b, T, nt, A), n no multiple
# of a tile's 16 poses, spheres and landmarks, stacks of 3 agents.
RAGGED = {
    "d2-ra-stack": (2, 37, 5, 3, 32, 4, 3),
    "d3-ra": (3, 45, 9, 2, 128, 2, 1),
    "d3-pgo-stack": (3, 70, 0, 0, 128, 3, 3),
    "d2-landmark": (2, 100, 0, 1, 32, 10, 1),
}


def _ragged(name, dtype, r_pad, seed=4):
    """A TiledMeta of RAGGED[name] with random flat operands (zero rows
    past RANK) and random Jacobi inverses."""
    d, n, l, b, T, nt, A = RAGGED[name]  # noqa: E741
    meta = tiled.TiledMeta(d=d, n=n, l=l, b=b, T=T, nt=nt)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = (A,) if A > 1 else ()

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device="cuda")

    X, V, E = (rand(r_pad, *lead, meta.kpad) for _ in range(3))
    for a in (X, V, E):
        a[RANK:] = 0.0
    TP = types.SimpleNamespace(
        meta=meta, jacobi={}, pose_inv=rand(*lead, n, d + 1, d + 1),
        sph_inv=rand(*lead, l), lmk_inv=rand(*lead, b))
    return meta, TP, X, V, E


@pytest.mark.parametrize("r_pad", [8, 16, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(RAGGED))
def test_ragged_tiles_match_plain(graphs, name, dtype, r_pad):
    """Every mode of both kernels on layouts that fill no tile evenly, at
    r_pad 8, 16 and 24 (more rows than one staged chunk): within RTOL of
    the plain version, its bits on the pose blocks, zero rows zero, and two
    launches bitwise equal."""
    meta, TP, X, V, E = _ragged(name, dtype, r_pad)
    aux = tiled.weingarten_setup(meta, X, V)
    aux_p = tiled._weingarten_setup_plain(meta, X, V)
    tol = RTOL[dtype]
    assert _rel_err(aux[0], aux_p[0]) <= tol
    if meta.l:
        assert _rel_err(aux[1], aux_p[1]) <= tol
    again = tiled.weingarten_setup(meta, X, V)
    assert all(torch.equal(a, b) for a, b in zip(aux, again))
    pairs = {
        "tangent": (lambda: tiled.tangent_project_flat(meta, X, V),
                    lambda: tiled._tangent_project_plain(meta, X, V)),
        "rhess": (lambda: tiled.flat_rhess(meta, X, V, E, aux),
                  lambda: tiled._rhess_plain(meta, X, V, E, aux)),
        "hess": (lambda: tiled.flat_rhess(meta, None, V, E, aux,
                                          project=False),
                 lambda: tiled._rhess_plain(meta, None, V, E, aux,
                                            project=False)),
        "precond": (lambda: tiled.flat_precond(TP, X, V),
                    lambda: tiled._tangent_project_plain(
                        meta, X, tiled._precondition_pose_plain(TP, V))),
    }
    for what, (kern, plain) in pairs.items():
        out, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()), what
        assert _rel_err(out, ref) <= tol, what
        assert torch.equal(out, again), what
        assert not out[RANK:].any(), what
        poses = (..., slice(0, meta.pose_end))
        assert torch.equal(out[poses], ref[poses]), what


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unaligned_operands_match_aligned(graphs, dtype):
    """Operands one element past a 16-byte boundary (contiguous views at
    an odd offset) take the kernels' elementwise copies in place of the
    bulk ones, and give the same bits in every mode."""
    meta, TP, X, V, E = _ragged("d3-ra", dtype, 16)

    def shifted(a):
        b = torch.empty(a.numel() + 1, dtype=dtype, device="cuda")[1:]
        return b.view(a.shape).copy_(a)

    Xs, Vs, Es = (shifted(a) for a in (X, V, E))
    assert Xs.is_contiguous() and Xs.data_ptr() % 16
    aux, aux_s = (tiled.weingarten_setup(meta, x, v)
                  for x, v in ((X, V), (Xs, Vs)))
    assert all(torch.equal(a, b) for a, b in zip(aux, aux_s))
    for out, ref in (
            (tiled.flat_rhess(meta, Xs, Vs, Es, aux),
             tiled.flat_rhess(meta, X, V, E, aux)),
            (tiled.flat_rhess(meta, None, Vs, Es, aux, project=False),
             tiled.flat_rhess(meta, None, V, E, aux, project=False)),
            (tiled.tangent_project_flat(meta, Xs, Vs),
             tiled.tangent_project_flat(meta, X, V)),
            (tiled.flat_precond(TP, Xs, Vs), tiled.flat_precond(TP, X, V))):
        assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stack_kernels_match_plain(graphs, dtype):
    """A [r_pad, A, kpad] stack of three agents with their own Jacobi
    blocks, as the parallel tiled round runs it."""
    g = graphs["grid"]
    TP = _problem(g, dtype)
    meta, A = TP.meta, 3
    Xs, Vs, Es = zip(*(_flat(TP, g, 8, seed=a) for a in range(A)))
    X, V, E = (torch.stack(t, 1).contiguous() for t in (Xs, Vs, Es))
    scale = torch.rand((A, meta.n, 1, 1), generator=torch.Generator()
                       .manual_seed(1), dtype=torch.float64) + 0.5
    TPs = dataclasses.replace(
        TP, pose_inv=(scale.to(TP.device, dtype) * TP.pose_inv).contiguous(),
        sph_inv=TP.sph_inv.expand(A, -1).contiguous(),
        lmk_inv=TP.lmk_inv.expand(A, -1).contiguous())
    aux = tiled.weingarten_setup(meta, X, V)
    aux_p = tiled._weingarten_setup_plain(meta, X, V)
    tol = RTOL[dtype]
    assert _rel_err(aux[0], aux_p[0]) <= tol
    for out, ref in (
            (tiled.tangent_project_flat(meta, X, V),
             tiled._tangent_project_plain(meta, X, V)),
            (tiled.flat_rhess(meta, X, V, E, aux),
             tiled._rhess_plain(meta, X, V, E, aux)),
            (tiled.flat_precond(TPs, X, V),
             tiled._tangent_project_plain(
                 meta, X, tiled._precondition_pose_plain(TPs, V)))):
        assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("name", ["grid", "ra"])
def test_flat_graph_equals_eager(graphs, name):
    """The flat tCG through its CUDA graph against the same iterations
    issued one by one, at two outer points (the second reloads the
    captured graph), with the Weingarten term: the same step count and
    the same bits of eta and Heta.  max_inner 6 is not a multiple of
    TCGGraph.STEPS, so the graph's masked overshoot must change nothing."""
    g = graphs[name]
    TP = _problem(g, torch.float64)
    X, V, _ = _flat(TP, g, 8, seed=7)
    be = rtr.FLAT_BACKEND
    graph = rtr.TCGGraph(be, TP, None, 6)
    for radius in (1e8, 0.5):
        egrad = tiled.egrad_flat(TP, X)
        grad = be.tangent(TP, X, egrad)
        rad = torch.tensor(radius, dtype=torch.float64, device="cuda")
        runs = [rtr.truncated_cg(TP, X, grad, egrad, None, rad, 6, 1e-12,
                                 1.0, be=be, graph=gr)
                for gr in (graph, None)]
        a, b = runs
        assert int(a.inner_iters) == int(b.inner_iters) > 0
        assert torch.equal(a.eta, b.eta) and torch.equal(a.Heta, b.Heta)
        X = be.retract(TP, X, 0.01 * grad)
    # per iteration: the Hessian's flat_rhess, and on the BTD problem the
    # projection after the solve
    assert graph.per_replay["flat_rhess"] == \
        graph.STEPS * (1 if name == "grid" else 2)
    assert graph.per_replay["spmm_sym"] == graph.STEPS
    assert graph.per_replay["flat_precond" if name == "grid"
                            else "btd_solve"] == graph.STEPS


def test_rtr_keeps_the_flat_graph(graphs):
    """rtr on the flat backend replays one graph per TiledProblem, shape
    and max_inner, kept across calls, and ends where the eager loop does
    (the same iterate bits)."""
    g = graphs["grid"]
    TP = _problem(g, torch.float64)
    X, _, _ = _flat(TP, g, 8, seed=9)
    cfg = rtr.RTRConfig(max_outer=3, max_inner=10)
    res = rtr.rtr(TP, None, None, X, cfg, be=rtr.FLAT_BACKEND)
    assert len(TP.tcg_graphs) == 1
    graph = next(iter(TP.tcg_graphs.values()))
    rtr.rtr(TP, None, None, X, cfg, be=rtr.FLAT_BACKEND)
    assert TP.tcg_graphs == {next(iter(TP.tcg_graphs)): graph}

    class Eager(type(rtr.FLAT_BACKEND)):
        pass

    eager = rtr.rtr(TP, None, None, X, cfg, be=Eager())  # no graph
    assert len(TP.tcg_graphs) == 1
    assert torch.equal(res.X, eager.X)
    assert float(res.f_final) == float(eager.f_final)
