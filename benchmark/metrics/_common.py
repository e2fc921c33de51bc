"""What several metrics read: the port's kernel names and their device
time in the window."""

from __future__ import annotations

import json
from pathlib import Path

KERNELS = json.loads((Path(__file__).parent / "kernels.json").read_text())


def kernel_seconds(record: dict, names) -> tuple[int, float]:
    """(calls, device seconds) of the window's kernels named in `names`."""
    rows = [r for n, r in record["kernel_s"].items() if n in set(names)]
    return sum(r[0] for r in rows), sum(r[1] for r in rows)


def port_kernels() -> list[str]:
    return KERNELS["dycore"] + KERNELS["physics"]


def peak(record: dict) -> dict | None:
    """The peaks of the run's device (harness/work.py), None where the
    table lacks it."""
    from benchmark.harness.work import peaks
    return peaks(record["device_name"])
