"""BENCHMARK.json against the contract's shape, and the harness's
discovery of every named file."""

import json
import os
import re

import pytest

import tiny
from harness import core

SPEC = core.bench_spec(tiny.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in SPEC["end_to_end"]}


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in SPEC["workloads"]])


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
                         + SPEC["per_layer"], ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    for k in entry.get("reduced", []):
        assert NAME.match(k)


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_points_at_a_reported_end_to_end_metric(metric):
    assert metric["moves"] in E2E
    target = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    for cell in _cells_of(metric):
        assert cell in _cells_of(target)
    if metric["unit"] == "%":
        assert metric["name"].endswith("_roofline") or "_roofline." in metric["name"] \
            or "mfu" in re.split(r"[._]", metric["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"] if cell in _cells_of(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert [m for m in SPEC["per_layer"] if cell in _cells_of(m)]


def test_setup_bound():
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_discovery_by_name(cell):
    w = core.workload(SPEC, cell)
    conf = core.load_json(core.find("configs", w["config"]))
    assert conf["name"] == w["config"]
    entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert entry["file"] == os.path.relpath(core.find("configs", w["config"]), tiny.ROOT)
    assert sorted(entry["reduced"]) == sorted(conf["reduced"])
    traffic = core.load_json(core.find("traffic", w["traffic"]))
    assert callable(core.load_module("drivers", traffic["driver"]).run)
    assert core.load_json(core.find("workloads", cell))["limits"]
    for m in SPEC["per_layer"]:
        if cell in _cells_of(m):
            assert callable(core.load_module("metrics", m["name"]).read)


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        core.find("traffic", "no-such-mix")
    with pytest.raises(KeyError):
        core.workload(SPEC, "no-such-cell")


def test_paths_hold_the_command():
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    for c in SPEC["configs"]:
        assert c["file"].startswith(SPEC["paths"][0] + "/")
