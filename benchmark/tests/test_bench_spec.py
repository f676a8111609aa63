"""BENCHMARK.json against the files of its cells and the contract's shape."""

import json
import os
import re

import pytest

from conftest import BENCH

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_every_entry_resolves_to_its_files(bench):
    from harness import spec

    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(BENCH, "workloads", w["name"] + ".json"))
        assert os.path.isfile(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        cell = spec.load(w["name"])
        assert cell.config["dataset_type"] in ("quad", "real")
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_names_and_units(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        for n in names:
            assert NAME.match(n), n
    for e in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


def test_metrics_cover_every_cell(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                              "device_trace")
    assert "workloads" not in e2e["setup_s"]
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for cell in cells:
        assert any(cell in m["workloads"] for m in bench["per_layer"])
        assert any(cell in m["workloads"] for m in bench["end_to_end"]
                   if m["name"] != "setup_s")


def test_workload_limits_are_numbers():
    for name in os.listdir(os.path.join(BENCH, "workloads")):
        with open(os.path.join(BENCH, "workloads", name)) as f:
            limits = json.load(f)["limits"]
        assert limits and all(isinstance(v, (int, float)) and v >= 0
                              for v in limits.values())
