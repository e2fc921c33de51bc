"""BENCHMARK.json and the files it names, found by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries, name: str, what: str) -> dict:
    """The entry of `entries` named `name`; raises KeyError naming `what`."""
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str, spec: dict | None = None,
              root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the workload `name`: the cell's
    entry, the configuration's file and the traffic mix's file."""
    spec = spec or load_spec(root)
    cell = find(spec["workloads"], name, "workload")
    cfg_entry = find(spec["configs"], cell["config"], "configuration")
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def _module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module of package benchmark.<kind>
    (the name may hold dots)."""
    key = f"benchmark.{kind}.{name}"
    if key not in sys.modules:
        importlib.import_module(f"benchmark.{kind}")
        path = BENCH_DIR / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def entry_module(traffic: dict):
    """The module of entries/ that drives the traffic's entry."""
    return _module("entries", traffic["entry"])


def metric_names(spec: dict, cell: dict, kind: str) -> list[str]:
    """The names of the `kind` ("end_to_end" or "per_layer") metrics the
    cell reports: those that list it, or that list no cells."""
    return [m["name"] for m in spec[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def metric_reader(name: str):
    """The `read(record)` function of metrics/<name>.py."""
    return _module("metrics", name).read
