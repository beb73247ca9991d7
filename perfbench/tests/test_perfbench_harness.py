"""``BENCHMARK.json`` as data: every cell's configuration, traffic, mix,
limits and per-layer readers are files found by name; names, units and
texts keep to the allowed characters; every per-layer metric's ``moves``
target is reported by every cell that lists the metric."""
from __future__ import annotations

import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_paths(bench):
    assert set(bench) == TOP
    assert bench["paths"] == ["perfbench"] and all(PATH.match(p) for p in bench["paths"])
    assert bench["command"][1] == "perfbench/run.py" and len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_finds_its_files_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert harness.data_file("configs", c["name"])["source"] == c["source"]
        assert _text(c["source"]) and _text(c["why"]) and len(c["reduced"]) <= 16
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and _text(w["why"])
        used.add(w["config"])
        traffic = harness.data_file("traffic", w["traffic"])
        mix = harness.module("mixes", traffic["mix"])
        assert callable(mix.run)
        limits = harness.limits_of(w["name"])
        assert limits and all(isinstance(v, (int, float)) for v in limits.values())
        for m in harness.metrics_of(bench, w["name"], trace=True):
            assert callable(harness.module("metrics", m["name"]).read)
    assert used == set(configs)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(
        bench["workloads"])


def test_names_units_and_keys(bench):
    rows = bench["end_to_end"] + bench["per_layer"]
    names = [r["name"] for r in rows] + [c["name"] for c in bench["configs"]] + [
        w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for r in rows:
        assert UNIT.match(r["unit"]) and r["better"] in ("lower", "higher")
        assert r["source"] in SOURCES
    for r in bench["end_to_end"]:
        assert set(r) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert r["source"] in ("host_clock", "device_trace")
        assert 0.01 <= r["bound"] <= 0.25
    for r in bench["per_layer"]:
        assert set(r) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                           "moves"}
        assert _text(r["layer"])
        if r["name"].endswith("_roofline") or "mfu" in r["name"]:
            assert r["unit"] == "%"


def test_moves_targets_are_reported_by_every_listed_cell(bench):
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {r["name"]: r for r in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in cells:
        mine = harness.metrics_of(bench, cell, trace=False)
        assert len(mine) >= 2 and harness.metrics_of(bench, cell, trace=True)
    for r in bench["per_layer"]:
        target = e2e[r["moves"]]
        for cell in r.get("workloads", cells):
            assert cell in cells
            assert cell in target.get("workloads", cells), (r["name"], cell)
