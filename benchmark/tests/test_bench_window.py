"""The aqua window's edges come from the program's driver: driver.run
times its graph capture in the "graph_capture" region and its replays in
"atm_step", through the PhaseTimer it looks up by that name. A driver
that changes any of these must make the harness fail, not move the
window."""

import json
import tempfile

import pytest
import torch

from benchmark.entries import driver_chunked as dc
from benchmark.harness import states
from benchmark.harness.spec import ROOT

from .conftest import TINY


def _strings(code) -> set:
    """Every string constant of `code` and of the functions nested in it."""
    out = set()
    for k in code.co_consts:
        if isinstance(k, str):
            out.add(k)
        elif hasattr(k, "co_consts"):
            out |= _strings(k)
    return out


def test_driver_names_the_regions_the_window_reads():
    from cam_nor_physics_tpu_torch import driver
    assert {dc.CAPTURE_REGION, dc.REPLAY_REGION} <= _strings(
        driver._run_chunked.__code__)
    assert "PhaseTimer" in driver.run.__code__.co_names


def _run_tiny(chunks, device="cpu"):
    from cam_nor_physics_tpu_torch import driver
    with open(ROOT / "benchmark" / "configs" / "aqua_f19.json") as f:
        cfg = dict(json.load(f), grid=TINY["aqua_f19"], dtype="float32")
    dev = torch.device(device)
    dyn0 = states.initial_dyn(cfg, 5, dev)
    model, atm, state, cam_in = dc.build(
        states.PORT, cfg, states.to_port(dyn0, torch.float32),
        torch.float32, dev)
    state = atm.atm_step(model, state, cam_in, first_step=True)[0]
    with tempfile.TemporaryDirectory() as out_dir, \
            dc._marking_timer(driver):
        _, timer = driver.run(model, state, cam_in, 2 * chunks,
                              out_dir=out_dir, hist_every=0, ckpt_every=0,
                              check_every=0, chunk=2)
    return timer


def test_cpu_run_marks_its_replays():
    timer = _run_tiny(2)
    assert dc.REPLAY_REGION in timer.ended
    dc.edges(timer, on_card=False)
    with pytest.raises(RuntimeError, match="graph_capture"):
        dc.edges(timer, on_card=True)


def test_unmarked_timer_raises():
    from cam_nor_physics_tpu_torch.utils.timing import PhaseTimer
    timer = PhaseTimer()
    timer.counts[dc.REPLAY_REGION] = 3
    with pytest.raises(RuntimeError, match="marking PhaseTimer"):
        dc.edges(timer, on_card=False)


@pytest.mark.cuda
def test_card_run_captures_once_and_replays():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    timer = _run_tiny(3, "cuda")
    dc.edges(timer, on_card=True)
    assert timer.counts[dc.CAPTURE_REGION] == 1
    assert timer.counts[dc.REPLAY_REGION] == 2
