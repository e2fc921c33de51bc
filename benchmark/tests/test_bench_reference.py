"""The frozen reference against the port's plain path (the CPU versions
of its kernels) at a tiny grid in float64: the same states and the same
count of work."""

import json

import pytest
import torch

from benchmark.entries import driver_chunked, hs_loop
from benchmark.harness import states
from benchmark.harness.spec import ROOT
from benchmark.harness.work import counting

from .conftest import TINY

F64 = torch.float64


def _config(name):
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        config = json.load(f)
    return dict(config, grid=TINY[name], dtype="float64")


def _assert_same(a, b):
    ta, tb = [], []
    states.map_tensors(a, ta.append)
    states.map_tensors(b, tb.append)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=0.0)


def test_translate_round_trip():
    dyn = states.initial_dyn(_config("aqua_f19"), 7, "cpu")
    port = states.to_port(dyn, F64)
    assert type(port).__module__.startswith(states.PORT)
    back = states.to_ref(port, F64)
    assert type(back) is type(dyn)
    _assert_same(dyn, back)


def test_initial_state_is_the_seeds():
    cfg = _config("hs_f05")
    a = states.initial_dyn(cfg, 3000000019, "cpu")
    b = states.initial_dyn(cfg, 3000000019, "cpu")
    c = states.initial_dyn(cfg, 3000000020, "cpu")
    assert torch.equal(a.pt, b.pt) and not torch.equal(a.pt, c.pt)
    # rounded once to the configuration's dtype
    a32 = states.initial_dyn(dict(cfg, dtype="float32"), 3, "cpu")
    assert torch.equal(a32.pt, a32.pt.float().double())


def test_hs_step_matches_the_port():
    from cam_nor_physics_tpu_torch.models.fv.dyn_comp import dyn_run
    from cam_nor_physics_tpu_torch.models.fv.grid import make_grid
    from cam_nor_physics_tpu_torch.models.fv.held_suarez import hs_forcing
    from cam_nor_physics_tpu_torch.models.fv.vertical import \
        hybrid_coefficients
    from cam_nor_physics_tpu_torch.utils.config import FVConfig
    cfg = _config("hs_f05")
    g = cfg["grid"]
    grid = make_grid(g["im"], g["jm"], g["km"], dtype=F64, device="cpu")
    coord = hybrid_coefficients(g["km"], dtype=F64, device="cpu")
    phis = torch.zeros((g["jm"], g["im"]), dtype=F64)
    dyn0 = states.initial_dyn(cfg, 11, "cpu")
    port = states.to_port(dyn0, F64)
    ref = dyn0
    step = hs_loop.reference_step(cfg, F64, torch.device("cpu"))
    for _ in range(2):
        port = hs_forcing(dyn_run(port, grid, coord, phis, FVConfig(), 1800.0),
                          grid, coord.ptop, 1800.0)
        ref = step(ref)
    _assert_same(states.to_ref(port, F64), ref)


def test_coupled_step_matches_the_port():
    cfg = _config("aqua_f19")
    dyn0 = states.initial_dyn(cfg, 12, "cpu")
    dev = torch.device("cpu")
    pm, patm, ps, pcam = driver_chunked.build(
        states.PORT, cfg, states.to_port(dyn0, F64), F64, dev)
    rm, ratm, rs, rcam = driver_chunked.build(states.REF, cfg, dyn0, F64,
                                              dev)
    _assert_same(states.to_ref(pcam, F64), rcam)
    ps = patm.atm_step(pm, ps, pcam, first_step=True)[0]
    rs = ratm.atm_step(rm, rs, rcam, first_step=True)[0]
    for _ in range(2):
        ps = patm.atm_step(pm, ps, pcam)[0]
        rs = ratm.atm_step(rm, rs, rcam)[0]
    _assert_same(states.to_ref(ps, F64), rs)


@pytest.mark.parametrize("name", ["aqua_f19", "hs_f05"])
def test_frozen_count_matches_the_ports_count(name):
    """The yardstick's count over the reference equals the port's own
    (ops/cost.py over its plain path) today; later changes to the port's
    count move nothing here."""
    from cam_nor_physics_tpu_torch.ops import cost
    from benchmark.tools.count_work import count
    cfg = _config(name)
    frozen = count(cfg, torch.device("cpu"))
    dev = torch.device("cpu")
    dyn0 = states.initial_dyn(cfg, 0, dev)
    with torch.no_grad():
        if name == "aqua_f19":
            m, atm, s, cam = driver_chunked.build(
                states.PORT, cfg, states.to_port(dyn0, F64), F64, dev)
            s = atm.atm_step(m, s, cam, first_step=True)[0]
            s = atm.atm_step(m, s, cam)[0]
            with cost.WorkCount() as c:
                atm.atm_step(m, s, cam)
        else:
            from cam_nor_physics_tpu_torch.models.fv.dyn_comp import dyn_run
            from cam_nor_physics_tpu_torch.models.fv.grid import make_grid
            from cam_nor_physics_tpu_torch.models.fv.held_suarez import \
                hs_forcing
            from cam_nor_physics_tpu_torch.models.fv.vertical import \
                hybrid_coefficients
            from cam_nor_physics_tpu_torch.utils.config import FVConfig
            g = cfg["grid"]
            grid = make_grid(g["im"], g["jm"], g["km"], dtype=F64,
                             device=dev)
            coord = hybrid_coefficients(g["km"], dtype=F64, device=dev)
            phis = torch.zeros((g["jm"], g["im"]), dtype=F64)

            def step(st):
                return hs_forcing(dyn_run(st, grid, coord, phis, FVConfig(),
                                          1800.0), grid, coord.ptop, 1800.0)
            s = states.to_port(dyn0, F64)
            for _ in range(2):
                s = step(s)
            with cost.WorkCount() as c:
                step(s)
    assert frozen["bytes_per_step"] == c.bytes
    assert frozen["ops_per_step"] == pytest.approx(c.ops, rel=1e-12)
    assert {k: v[0] for k, v in frozen["kernels"].items()} == {
        k: v[0] for k, v in c.kernels.items()}


def test_counting_restores_the_reference():
    from benchmark.reference.ops import cd_fused_kernels
    k1 = cd_fused_kernels.k1
    with counting():
        assert cd_fused_kernels.k1 is not k1
    assert cd_fused_kernels.k1 is k1
