"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs present under the benchmark's folder."""

import json
import os
import re

from port_bench.tests.conftest import ROOT

MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    for w in cmd:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in MAN["paths"])


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    assert len(names) == len(set(names))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in MAN["workloads"]:
        assert _text(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in MAN["configs"]:
        assert _text(c["source"]) and _text(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in MAN["per_layer"]:
        assert _text(m["layer"])


def test_entry_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"}
               for c in MAN["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in MAN["workloads"])
    base = {"name", "unit", "better", "source"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == base | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == base | {"layer", "moves"}


def _reports(workload):
    return {m["name"] for m in MAN["end_to_end"]
            if workload in m.get("workloads", [workload])}


def test_each_cell_reports_enough():
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in MAN["end_to_end"])
    for w in MAN["workloads"]:
        e2e = _reports(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [])
                   or ("workloads" not in m and m["moves"] in e2e)
                   for m in MAN["per_layer"])


def test_every_metric_moves_one_its_cells_report():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells and m["moves"] in _reports(w), (m["name"], w)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(1 for w in MAN["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_each_pair_once_and_every_config_used():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in MAN["configs"]} == {p[0] for p in pairs}


def test_files_of_every_cell_exist():
    files = set()
    for c in MAN["configs"]:
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    bench = os.path.join(ROOT, "port_bench")
    for w in MAN["workloads"]:
        mix = json.load(open(os.path.join(bench, "traffic",
                                          w["traffic"] + ".json")))
        assert os.path.exists(os.path.join(bench, "entries",
                                           mix["entry"] + ".py"))
        lim = json.load(open(os.path.join(bench, "limits",
                                          w["name"] + ".json")))
        assert all(v["limit"] is not None for v in lim["limits"].values())
    for m in MAN["per_layer"]:
        assert os.path.exists(os.path.join(bench, "metrics",
                                           m["name"] + ".py"))


def test_the_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert isinstance(MAN["run_seconds"], int) and \
        1 <= MAN["run_seconds"] <= 51
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
