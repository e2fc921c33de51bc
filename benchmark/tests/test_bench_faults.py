"""A whole run of each cell on the CPU at a tiny grid, past the harness's
look for a card, with the timed path broken underneath: `correct` comes
out false for each fault the cells can have: a step that returns its
state unchanged, half of the batch (the southern rows) left out, and an
answer altered where it is produced (pt off by a hundredth)."""

import pytest
import torch

from benchmark import run
from benchmark.harness import spec as specs

from .conftest import TINY


def unchanged(old, new):
    return old


def half(old, new):
    h = old.pt.shape[-2] // 2

    def keep(o, n):
        n = n.clone()
        n[..., :h, :] = o[..., :h, :]
        return n
    return new.replace(u=keep(old.u, new.u), v=keep(old.v, new.v),
                       pt=keep(old.pt, new.pt), delp=keep(old.delp, new.delp),
                       q=keep(old.q, new.q))


def altered(old, new):
    return new.replace(pt=new.pt * (1.0 + 1e-2))


def _break(monkeypatch, workload, fault):
    if workload.startswith("aqua"):
        from cam_nor_physics_tpu_torch import driver
        from cam_nor_physics_tpu_torch.models import atm_comp
        orig = atm_comp.atm_step

        def broken(model, state, cam_in, first_step=False, mesh=None):
            new, out, diags = orig(model, state, cam_in, first_step, mesh)
            return new.replace(dyn=fault(state.dyn, new.dyn)), out, diags
        monkeypatch.setattr(atm_comp, "atm_step", broken)
        monkeypatch.setattr(driver, "atm_step", broken)
    else:
        from cam_nor_physics_tpu_torch.models.fv import dyn_comp
        orig = dyn_comp.dyn_run

        def broken(state, *args, **kwargs):
            return fault(state, orig(state, *args, **kwargs))
        monkeypatch.setattr(dyn_comp, "dyn_run", broken)


def _run(workload):
    _, config, _ = specs.load_cell(workload)
    args = run.parse_args(["--workload", workload, "--seed", "2147483659",
                           "--seconds", "0.5", "--trace", "0"])
    return run.run_cell(args, device="cpu",
                        overrides={"grid": TINY[config["name"]]})


@pytest.mark.parametrize("workload", ["aqua_f19.monthly_hist",
                                      "hs_f05.climate"])
@pytest.mark.parametrize("fault", [unchanged, half, altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(monkeypatch, workload, fault):
    _break(monkeypatch, workload, fault)
    result, lines = _run(workload)
    assert result["correct"] is False, lines
    assert any("FAIL" in line for line in lines)


@pytest.mark.parametrize("workload", ["aqua_f19.monthly_hist",
                                      "hs_f05.climate"])
def test_sound_run_is_correct(workload):
    result, lines = _run(workload)
    assert result["correct"] is True, lines
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == {"sypd", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["aqua_f19.monthly_hist",
                                      "hs_f05.climate"])
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = run.parse_args(["--workload", workload, "--seed", "2147483661",
                           "--seconds", "2", "--trace", "0"])
    result, lines = run.run_cell(args)
    assert result["correct"] is True, lines
    assert result["device"]["platform"] == "gpu"
