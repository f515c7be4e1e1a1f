"""The per-layer metrics that read what the port records (its stage
parts, spans and counters, port_bench/program.py), on synthetic readings
small enough to count by hand; and each gives None where the port records
nothing, as a port older than its spans does."""

from collections import Counter

import pytest

from port_bench import trace as tr

STAGES = [
    {"init_s": 1.0, "solve": 3.0, "solve/build": 0.5, "solve/edge": 1.0,
     "certify": 10.0, "certify/lanczos": 3.0, "certify/assemble": 0.5,
     "certify/ldlt": 6.0},
    # a solve without the assembly and the edge phase counts 0 for them
    {"init_s": 1.0, "solve": 2.0, "certify": 12.0, "certify/lanczos": 4.0,
     "certify/ldlt": 7.0},
]
OLD_STAGES = [{"init_s": 1.0, "solve": 3.0, "certify": 10.0}]


def _metric(name):
    from port_bench import harness

    return harness.load_metric(name)


def reading(mix="certify", stages=(), dev=(), host=()):
    return tr.Reading(tr.Reduced(list(dev), list(host)), 1.0, Counter(),
                      list(stages), None, None, "float32", None, mix)


@pytest.mark.parametrize("name, want", [
    ("lanczos_s", 3.5), ("s_assembly_s", 0.25), ("ldlt_proof_s", 6.5),
    ("edge_phase_s", 0.5)])
def test_stage_parts_average_over_the_solves(name, want):
    assert _metric(name)(reading(stages=STAGES)) == pytest.approx(want)
    assert _metric(name)(reading(stages=OLD_STAGES)) is None
    assert _metric(name)(reading(stages=[])) is None


def _counters(monkeypatch, values):
    from dcora_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "counters", lambda: dict(values))


COUNTS = {"certify.calls": 4, "lanczos.steps": 1024, "rtr.outer": 50,
          "tcg.issued": 2000, "tcg.useful": 1500}


@pytest.mark.parametrize("name, mix, want", [
    ("lanczos_steps", "certify", 256.0),
    ("tcg_iters_per_outer", "rtr", 30.0),
    ("tcg_masked_pct", "rtr", 25.0)])
def test_counter_ratios(monkeypatch, name, mix, want):
    _counters(monkeypatch, COUNTS)
    read = _metric(name)
    assert read(reading(mix=mix)) == pytest.approx(want)
    other = "rtr" if mix == "certify" else "certify"
    assert read(reading(mix=other)) is None  # outside its entry
    _counters(monkeypatch, {})
    assert read(reading(mix=mix)) is None  # nothing counted


def test_counter_readers_of_a_port_without_counters(monkeypatch):
    from dcora_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "counters")
    for name, mix in (("lanczos_steps", "certify"),
                      ("tcg_iters_per_outer", "rtr"),
                      ("tcg_masked_pct", "rtr")):
        assert _metric(name)(reading(mix=mix)) is None


# two outer iterations of 10 us, each with a tCG call of 6 us; the card
# busy 2 us of the first call (half of a 4 us kernel that starts before
# it) and 3 us of the second, and busy outside the calls besides
HOST = [(0.0, 10.0, "dcora.rtr.outer"), (1.0, 7.0, "dcora.rtr.tcg"),
        (2.0, 3.0, "aten::add"), (10.0, 20.0, "dcora.rtr.outer"),
        (12.0, 18.0, "dcora.rtr.tcg")]
DEV = [(-1.0, 3.0, "k"), (8.0, 9.0, "k"), (12.0, 13.0, "k"),
       (15.0, 16.0, "k"), (17.0, 19.0, "k")]


def test_tcg_idle_share_inside_the_tcg_spans():
    r = reading(mix="rtr", dev=DEV, host=HOST)
    assert _metric("tcg_idle_pct")(r) == pytest.approx(
        100.0 * (1.0 - 5.0 / 12.0))
    assert _metric("tcg_idle_pct")(reading(mix="certify", dev=DEV,
                                           host=HOST)) is None


def test_outer_rest_per_outer():
    r = reading(mix="rtr", dev=DEV, host=HOST)
    assert _metric("outer_rest_ms")(r) == pytest.approx(1e-3 * 8.0 / 2)
    assert _metric("outer_rest_ms")(reading(mix="certify", dev=DEV,
                                            host=HOST)) is None


def test_span_readers_without_spans():
    host = [(s, e, n) for s, e, n in HOST if not n.startswith("dcora.")]
    for name in ("tcg_idle_pct", "outer_rest_ms"):
        assert _metric(name)(reading(mix="rtr", dev=DEV, host=host)) is None
