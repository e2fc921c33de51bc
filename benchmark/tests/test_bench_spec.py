"""BENCHMARK.json and the files it names, found by name."""

import json
import re

import pytest

from benchmark.harness import spec as specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return specs.load_spec()


def test_keys_and_names(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"][:2] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[kind]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["moves"] in e2e for m in spec["per_layer"])


def test_every_cell_finds_its_files(spec):
    for cell in spec["workloads"]:
        got, config, traffic = specs.load_cell(cell["name"], spec)
        assert got is cell and cell["chips"] == 1
        entry = specs.entry_module(traffic)
        assert callable(entry.measure) and callable(entry.check)
        checks = {c["check"] for c in config["compared"].values()}
        assert checks == {"start", "end"}
        assert all(0 < c["limit"] < 1 for c in config["compared"].values())
        assert specs.metric_names(spec, cell, "end_to_end") == [
            "sypd", "setup_s"]
        for name in specs.metric_names(spec, cell, "per_layer"):
            assert callable(specs.metric_reader(name))


def test_configs_are_uncut(spec):
    for c in spec["configs"]:
        with open(specs.ROOT / c["file"]) as f:
            config = json.load(f)
        assert config["name"] == c["name"]
        assert c["reduced"] == config["reduced"] == []
        assert config["dtype"] == "float32" and config["dt"] == 1800.0
        assert config["work"]["ops_per_step"] > 0


def test_unknown_names_raise(spec):
    with pytest.raises(KeyError, match="no workload"):
        specs.load_cell("no_such.cell", spec)
    with pytest.raises(FileNotFoundError):
        specs.metric_reader("no_such_metric")
