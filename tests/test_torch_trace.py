"""The port's spans and counters (dcora_tpu_torch.utils.timing): a span
enters a record function only while a profiler records, and then shows in
the profile as a host event inside its parent; the staircase's and
rtr_fast's parts sum to no more than their stage; solve_pgo's stats keep
their keys; the tCG counters count what the solver did.  All on the CPU,
on generated sets."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dcora_tpu_torch import datasets, solvers
from dcora_tpu_torch.core import lifted, problem as prob, rtr as rtr_mod
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.init import chordal_initialization
from dcora_tpu_torch.drivers import single_robot_pgo
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.utils import timing

CERTIFY_PARTS = {"certify/blocks", "certify/lanczos", "certify/assemble",
                 "certify/ldlt"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's solver loops issue tiny ops, which a thread pool beside
    the other test workers slows down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    return {name: datasets.generate_grid_g2o(str(d / name), **cfg)
            for name, cfg in datasets._TEST_SETS.items()}


def _spans(prof):
    """{name: [(start_ns, end_ns), ...]} of the profile's dcora spans,
    all of them host events (none a user annotation, which the profiler
    would draw again on the device's timeline)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("dcora."):
            assert e.device_type() == torch.autograd.DeviceType.CPU
            assert not e.is_user_annotation()
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer):
    return all(any(s <= a and b <= e for s, e in outer) for a, b in inner)


class _Recorder:
    """A stand-in for the record function a span enters, noting each
    span it is asked to enter."""

    entered = []

    def __init__(self, name):
        self.entered.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    monkeypatch.setattr(_Recorder, "entered", [])
    monkeypatch.setattr(timing, "_record", _Recorder)
    into = {}
    for _ in range(3):
        with timing.span("a", into=into) as sp:
            with timing.span("a/b", into=into):
                pass
    assert _Recorder.entered == []
    assert set(into) == {"a", "a/b"} and into["a"] >= sp.seconds >= 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("c"):
            pass
    assert _Recorder.entered == ["dcora.c"]


def test_nested_spans_show_inside_their_parent():
    into = {}
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for _ in range(2):
            with timing.span("outer", into=into):
                with timing.span("outer/inner", into=into):
                    torch.ones(64).cumsum(0)
    spans = _spans(p)
    assert len(spans["dcora.outer"]) == len(spans["dcora.outer/inner"]) == 2
    assert _inside(spans["dcora.outer/inner"], spans["dcora.outer"])
    assert into["outer"] >= into["outer/inner"] > 0.0


def test_a_span_that_raises_still_ends_and_counts():
    into = {}
    with pytest.raises(ValueError):
        with timing.span("fails", into=into):
            with timing.span("fails/part", into=into):
                raise ValueError
    assert into["fails"] >= into["fails/part"] >= 0.0


def test_a_span_without_into_adds_nowhere():
    into = {}
    with timing.span("stage", into=into):
        with timing.span("stage/part") as part:
            pass
    assert set(into) == {"stage"} and part.seconds >= 0.0


def test_counters_add_host_and_device_counts():
    timing.reset_counters()
    timing.count("x")
    timing.count("x", 4)
    timing.count("y", torch.tensor(3, dtype=torch.int32))
    timing.count("y", torch.tensor([1, 2], dtype=torch.int32))
    assert timing.counters() == {"x": 5, "y": 6}
    timing.reset_counters()
    assert timing.counters() == {}


@pytest.mark.parametrize("counts, mix, want", [
    ({"lanczos.steps": 256, "lanczos.graph_steps": 192}, "certify", 75.0),
    ({"lanczos.steps": 256, "lanczos.graph_steps": 0}, "certify", 0.0),
    ({"lanczos.steps": 256}, "certify", None),  # a port without graphs
    ({"lanczos.steps": 256, "lanczos.graph_steps": 256}, "rtr", None)])
def test_lanczos_graph_pct_reads_the_counters(monkeypatch, counts, mix,
                                              want):
    """The benchmark's lanczos_graph_pct: 100 graph steps / steps of the
    port's counters in the certify entry, None where the port counts no
    graph steps and outside the entry."""
    from collections import Counter

    from port_bench import harness, trace as tr

    monkeypatch.setattr(timing, "counters", lambda: dict(counts))
    reading = tr.Reading(tr.Reduced([], []), 1.0, Counter(), [], None,
                         None, "float64", None, mix)
    got = harness.load_metric("lanczos_graph_pct")(reading)
    assert got == (None if want is None else pytest.approx(want))


def test_certified_solve_parts_sum_to_at_most_their_stage(grids):
    """The driver's certified solve on the CPU: the certify stage's parts
    are there and sum to no more than the stage; init_s is the graph and
    the chordal init; the spans nest as the layers do."""
    timing.reset_counters()
    res = {}
    with profile(activities=[ProfilerActivity.CPU]) as p:
        single_robot_pgo.run(grids["tinyGrid3D.g2o"], certify=True,
                             device="cpu", verbose=False, result=res)
    st = res["staircase"]
    assert st.certified
    stages = st.stage_seconds
    assert {"solve", "certify", "round", "refine"} <= set(stages)
    assert CERTIFY_PARTS <= set(stages)
    parts = [k for k in stages if k.startswith("certify/")]
    assert sum(stages[k] for k in parts) <= stages["certify"]
    assert res["init_s"] > 0.0 and res["read_s"] > 0.0

    spans = _spans(p)
    for name in ("pgo.read", "pgo.graph", "pgo.init", "pgo.staircase",
                 "pgo.output", "staircase.setup", "solve", "certify",
                 "rtr.outer", "rtr.tcg"):
        assert "dcora." + name in spans, name
    assert _inside(spans["dcora.staircase.setup"],
                   spans["dcora.pgo.staircase"])
    for part in CERTIFY_PARTS:
        assert _inside(spans["dcora." + part], spans["dcora.certify"])
    assert _inside(spans["dcora.rtr.tcg"], spans["dcora.rtr.outer"])
    c = timing.counters()
    assert c["certify.calls"] == len(spans["dcora.certify"])
    assert c["lanczos.steps"] > 0
    assert c["rtr.outer"] == len(spans["dcora.rtr.outer"])


def test_rtr_fast_parts(grids):
    """rtr_fast's phases on the CPU's tile path, inside a "solve" stage
    whose dict it is handed as `stats`, as the staircase does: the parts
    are there and sum to no more than the stage."""
    ms = read_g2o_file(grids["smallGrid3D.g2o"]).pose_pose_measurements
    g = LocalGraph(0, 5, 3)
    g.set_measurements(ms)
    P = g.problem_data(device="cpu")
    M = solvers.make_preconditioner(g, P)
    X0 = lifted.pad_rank(lifted.from_pose_array(
        chordal_initialization(ms, device="cpu")), 5)
    cfg = rtr_mod.RTRConfig(gradnorm_tol=1e-6, max_outer=30, max_inner=50)
    stages = {}
    with timing.span("solve", into=stages):
        solvers.rtr_fast(g, P, M, X0, cfg, stats=stages)
    assert {"solve/build", "solve/tiles_f32", "solve/edge"} <= set(stages)
    assert sum(v for k, v in stages.items() if k != "solve") \
        <= stages["solve"]


def test_solve_pgo_stats_keep_their_keys(grids, monkeypatch):
    """solve_pgo's stats on rtr_fast's path: the chordal init, the tile
    builds and the whole call, under the keys they always had."""
    ms = read_g2o_file(grids["smallGrid3D.g2o"]).pose_pose_measurements
    monkeypatch.setattr(solvers, "FAST_PATH_MIN_POSES", 0)
    stats = {}
    solvers.solve_pgo(ms, solvers.ROptParameters(
        gradnorm_tol=1e-6, RTR_iterations=30, RTR_tCG_iterations=50),
        device="cpu", stats=stats)
    assert set(stats) == {"init_s", "build_s", "total_s"}
    assert stats["init_s"] > 0.0 and stats["build_s"] > 0.0
    assert stats["init_s"] + stats["build_s"] <= stats["total_s"]


def test_tcg_counters_count_the_solver(grids, monkeypatch):
    """On the CPU's edge path: tcg.issued >= tcg.useful, tcg.useful is
    the sum of the tCG calls' inner iterations and rtr.outer the outer
    iterations."""
    ms = read_g2o_file(grids["smallGrid3D.g2o"]).pose_pose_measurements
    g = LocalGraph(0, 5, 3)
    g.set_measurements(ms)
    P = g.problem_data(device="cpu")
    M = solvers.make_preconditioner(g, P)
    X0 = lifted.pad_rank(lifted.from_pose_array(
        chordal_initialization(ms, device="cpu")), 5)
    G = lifted.zeros(g.dims, 5, device="cpu")
    inner, real = [], rtr_mod.truncated_cg

    def recording(*a, **kw):
        out = real(*a, **kw)
        inner.append(int(out.inner_iters))
        return out

    monkeypatch.setattr(rtr_mod, "truncated_cg", recording)
    timing.reset_counters()
    res = rtr_mod.rtr(P, G, M, X0, rtr_mod.RTRConfig(
        gradnorm_tol=1e-8, max_outer=6, max_inner=40))
    c = timing.counters()
    assert res.outer_iters == c["rtr.outer"] == len(inner) > 0
    assert c["tcg.useful"] == sum(inner) > 0
    assert c["tcg.issued"] >= c["tcg.useful"]
    assert float(prob.cost(P, res.X)) < float(prob.cost(P, X0))
