"""BENCHMARK.json against the benchmark's contract: names, units and text
fields in their alphabets and lengths, every entry's keys, and every cell's
configuration, traffic mix and metric readers found by name."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(bench, section):
    need, optional = KEYS[section]
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        assert need <= set(e) <= need | optional, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and section != "per_layer":
                assert _text(e[key]), (e["name"], key)
        if section == "per_layer":
            assert _text(e["layer"])


def test_cells_and_bounds(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(cells) <= 24 and 1 <= len(configs) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    for w in cells.values():
        assert w["config"] in configs and w["chips"] in (1, 4) and NAME.match(w["traffic"])
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reports = [m for m in e2e.values() if cell in m.get("workloads", cells)]
        assert len(reports) >= 2 and any(m["name"] == "setup_s" for m in reports)
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_files_found_by_name(bench):
    from portbench import run
    for c in bench["configs"]:
        assert PATH.match(c["file"]) and c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert set(c["reduced"]) <= set(conf.get("reduced", {}))
        assert _text(c["source"]) and _text(c["why"])
    for w in bench["workloads"]:
        cell, config, traffic = run.cell_parts(bench, w["name"])
        assert callable(run.workload.load("kinds", traffic["kind"]).Work)
        if "circuit" in config:
            assert callable(run.workload.load("circuits", config["circuit"]).r1cs)
        for kind in ("end_to_end", "per_layer"):
            for m in run.cell_metrics(bench, w["name"], kind):
                assert callable(run.load_reader(m["name"]).read)


def test_only_benchmark_files_under_paths():
    for dirpath, _, files in os.walk(HERE):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel
