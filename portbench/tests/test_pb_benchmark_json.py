"""BENCHMARK.json against the benchmark's contract, and its files."""

import os
import re

import pytest

from portbench import ROOT, run

BENCH = run.load_json("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p and not p.startswith("/")
    assert len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4) and set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"]) and set(m) <= METRIC_KEYS | {"layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound", "workloads"} and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_what_its_per_layer_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        names = [m["name"] for m in BENCH["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in names and len(names) >= 2
        assert any(_reports(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    wl, cfg, traffic = run.cell_spec(BENCH, cell)
    assert os.path.exists(os.path.join(ROOT, "portbench", "drivers", traffic["driver"] + ".py"))
    assert os.path.exists(os.path.join(ROOT, "portbench", "reference", cfg["family"] + ".py"))
    for m in BENCH["per_layer"]:
        if _reports(m, cell):
            assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
    entry = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert entry["file"].startswith("portbench/") and cfg["name"] == entry["name"]
