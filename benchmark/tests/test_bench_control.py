"""The comparison's control, at a tiny grid on the CPU: the reference
computed in float32 with its state held in bfloat16 between steps (the
precision below the configurations' float32), put in the program's
place, reads above some limit, while the program reads below them all."""

import pytest

from benchmark.harness import spec as specs
from benchmark.harness.compare import limits_of
from benchmark.tools.readings import readings

from .conftest import TINY


@pytest.mark.parametrize("workload", ["aqua_f19.monthly_hist",
                                      "hs_f05.climate"])
def test_control_fails_and_program_passes(workload):
    _, config, _ = specs.load_cell(workload)
    got = readings(workload, 2**31 + 17, 1.0, device="cpu",
                   overrides={"grid": TINY[config["name"]]})
    limits = limits_of(config["compared"])
    for k, lim in limits.items():
        assert got["program"][k] <= lim, (k, got["program"])
    assert any(not got["control"][k] <= lim for k, lim in limits.items()), \
        got["control"]
