"""The port's vertical remap, filler, te_map and Held-Suarez forcing against
the JAX package, float64 on the CPU, at 1e-12 relative to each output's
largest magnitude (trac2d is held to JAX inside the slice test, and its
parts tracer_div3d and fillz on their own).

te_map_remap_ref (the plain version of the te_map CUDA kernel) is held to
the Pallas kernel run by the interpreter (te_map_remap_pallas(interpret=
True)) and to ops/remap.py's ppm_remap/ppm_remap_multi, on random columns
whose source and target interfaces share their end points, as te_map's do.
The kernel's source, csrc/remap_kernels.cu built as host C++
(torch_port_util.host_build), is held bitwise to te_map_remap_ref in
float32 and float64 (`HOST_CASES`), and on columns with a NaN or an inf
below a target or crossed interfaces to NaN where the plain version has
NaN and bitwise elsewhere (`ODD_CASES`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cam_nor_physics_tpu.models.fv import cd_core as jcd
from cam_nor_physics_tpu.models.fv import dyn_comp as jdc
from cam_nor_physics_tpu.models.fv import grid as jgrid
from cam_nor_physics_tpu.models.fv import held_suarez as jhs
from cam_nor_physics_tpu.models.fv import vertical as jvert
from cam_nor_physics_tpu.ops import fill as jfill
from cam_nor_physics_tpu.ops import remap as jremap
from cam_nor_physics_tpu.ops.remap_pallas import te_map_remap_pallas
from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.models.fv import dyn_comp as tdc
from cam_nor_physics_tpu_torch.models.fv import grid as tgrid
from cam_nor_physics_tpu_torch.models.fv import held_suarez as ths
from cam_nor_physics_tpu_torch.models.fv import vertical as tvert
from cam_nor_physics_tpu_torch.ops import fill as tfill
from cam_nor_physics_tpu_torch.ops import remap as tremap
from cam_nor_physics_tpu_torch.ops import remap_kernels as trk
from torch_port_util import assert_close, host_build, t64

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

TOL = 1e-12


def _interfaces(rng, km, ncol, jitter):
    """(km+1, ncol) increasing interfaces from 200 Pa to ~1e5 Pa."""
    base = np.linspace(0.0, 1.0, km + 1) ** 1.5
    pe = base[:, None] + jitter * rng.uniform(-1, 1, (km + 1, ncol)) / km
    pe[0], pe[-1] = 0.0, 1.0
    pe = np.sort(pe, axis=0)
    return 200.0 + (1e5 - 200.0) * pe


def _remap_inputs(seed, km=8, ncol=40, nf=2):
    rng = np.random.default_rng(seed)
    pes = [_interfaces(rng, km, ncol, j) for j in (0.3, 0.0, 0.3, 0.1, 0.3,
                                                   0.1)]
    fields = [250.0 + 30.0 * rng.standard_normal((km, ncol))
              for _ in range(nf)]
    u = 10.0 * rng.standard_normal((km, ncol))
    v = 10.0 * rng.standard_normal((km, ncol))
    return pes, fields, u, v


@pytest.mark.parametrize("kord", [2, 3, 4])
def test_te_map_remap_ref_matches_pallas_and_remap(kord):
    pes, fields, u, v = _remap_inputs(seed=kord)
    cen, u2, v2 = trk.te_map_remap(*[t64(p) for p in pes],
                                   [t64(f) for f in fields], t64(u), t64(v),
                                   kord)
    jpes = [jnp.asarray(p) for p in pes]
    pcen, pu, pv = te_map_remap_pallas(*jpes, [jnp.asarray(f)
                                               for f in fields],
                                       jnp.asarray(u), jnp.asarray(v), kord,
                                       block_cols=128, interpret=True)
    for g, w in zip(cen + [u2, v2], list(pcen) + [pu, pv]):
        assert_close(g, w, TOL, "pallas")
    # ops/remap.py (the JAX te_map's own path), (ncol, km) layout
    want = jremap.ppm_remap_multi(pes[0].T, np.stack([f.T for f in fields]),
                                  pes[1].T, kord)
    for g, w in zip(cen, want):
        assert_close(g, np.asarray(w).T, TOL, "ppm_remap_multi")
    assert_close(u2, np.asarray(jremap.ppm_remap(pes[2].T, u.T, pes[3].T,
                                                 kord)).T, TOL, "ppm_remap")


def test_ppm_remap_port_matches_jax_and_conserves():
    pes, fields, u, _ = _remap_inputs(seed=7)
    src, tgt = pes[0].T, pes[1].T
    got = tremap.ppm_remap(t64(src), t64(u.T), t64(tgt), 4)
    assert_close(got, jremap.ppm_remap(src, u.T, tgt, 4), TOL)
    mass0 = (u.T * np.diff(src, axis=1)).sum(1)
    mass1 = (got.numpy() * np.diff(tgt, axis=1)).sum(1)
    assert_close(mass1, mass0, 1e-13, "column mass")
    multi = tremap.ppm_remap_multi(t64(src), t64(np.stack([f.T for f in
                                                           fields])),
                                   t64(tgt), 3)
    want = jremap.ppm_remap_multi(src, np.stack([f.T for f in fields]), tgt,
                                  3)
    assert_close(multi, want, TOL)


def test_fill_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.uniform(-1e-3, 3e-3, (3, 5, 7))
    dp = rng.uniform(100.0, 2000.0, (3, 5, 7))
    for a, b in zip(tfill.fillz(t64(q), t64(dp)), jfill.fillz(q, dp)):
        assert_close(a, b, 1e-15)
    got = tfill.qneg3(t64(q))
    want = jfill.qneg3(q)
    assert_close(got[0], want[0], 0.0)
    assert float(got[1]) == float(want[1]) and int(got[2]) == int(want[2])


def _hs(im=36, jm=24, km=6, seed=3):
    """A Held-Suarez state with winds and a tracer, as numpy arrays."""
    rng = np.random.default_rng(seed)
    tg = tgrid.make_grid(im, jm, km, device="cpu")
    tc = tvert.hybrid_coefficients(km, device="cpu")
    st = convert.dynstate_to_numpy(ths.hs_initial_state(tg, tc))
    st["u"] = 5.0 * rng.standard_normal((km, jm, im))
    st["v"] = 5.0 * rng.standard_normal((km, jm, im))
    st["delp"] = st["delp"] * (1.0 + 0.02 * rng.standard_normal(
        (km, jm, im)))
    st["q"] = rng.uniform(0.0, 1e-2, (2, km, jm, im))
    return st, tg, tc, jgrid.make_grid(im, jm, km), jvert.hybrid_coefficients(
        km)


@pytest.mark.parametrize("consv", [False, True])
def test_te_map_matches_jax(consv):
    st, tg, tc, jg, jc = _hs()
    got = tdc.te_map(convert.dynstate_from_numpy(st, "cpu"), tc, tg, tc.ptop,
                     consv=consv)
    want = jdc.te_map(jcd.DynState(**{f: jnp.asarray(a)
                                      for f, a in st.items()}),
                      jc, jg, jc.ptop, consv=consv, use_pallas=False)
    for f in convert.STATE_FIELDS:
        assert_close(getattr(got, f), getattr(want, f), TOL, f)


def test_hs_forcing_and_initial_state_match_jax():
    st, tg, tc, jg, jc = _hs(seed=1)
    jst = jhs.hs_initial_state(jg, jc, pert=1.0, dtype=jnp.float64)
    tst = ths.hs_initial_state(tg, tc, pert=1.0)
    for f in convert.STATE_FIELDS:
        assert_close(getattr(tst, f), getattr(jst, f), 1e-15, f)
    got = ths.hs_forcing(convert.dynstate_from_numpy(st, "cpu"), tg, tc.ptop,
                         1800.0)
    want = jhs.hs_forcing(jcd.DynState(**{f: jnp.asarray(a)
                                          for f, a in st.items()}),
                          jg, jc.ptop, 1800.0)
    for f in ("u", "v", "pt"):
        assert_close(getattr(got, f), getattr(want, f), 1e-14, f)


def test_te_map_remap_refuses_what_the_kernel_cannot_take():
    pes, fields, u, v = _remap_inputs(seed=1, km=4, ncol=6)
    args = [t64(p) for p in pes] + [[t64(f) for f in fields], t64(u),
                                     t64(v)]
    bad = list(args)
    bad[8] = bad[8].float()
    with pytest.raises(TypeError, match="v is torch.float32"):
        trk.te_map_remap(*bad)
    bad = list(args)
    bad[0] = bad[0].T.contiguous().T
    with pytest.raises(ValueError, match="pe_s"):
        trk.te_map_remap(*bad)
    km = trk.MAX_LEVELS + 1
    deep = [torch.zeros((km + 1, 3), dtype=torch.float64)] * 6 + \
        [[torch.zeros((km, 3), dtype=torch.float64)]] + \
        [torch.zeros((km, 3), dtype=torch.float64)] * 2
    with pytest.raises(ValueError, match="levels"):
        trk.te_map_remap(*deep)


# te_map_remap's CUDA source as host C++ against te_map_remap_ref, bitwise,
# at 10 levels and 40 columns (one ragged block of 128 threads). Each case:
# (kord, nf, km_t, what else the inputs hold)
HOST_KM, HOST_NCOL = 10, 40
HOST_CASES = {
    "kord2": (2, 2, HOST_KM, ()),
    "kord3": (3, 2, HOST_KM, ()),
    "kord4": (4, 2, HOST_KM, ()),
    "nf1": (4, 1, HOST_KM, ()),
    "nf3_zero_tracer": (4, 3, HOST_KM, ("zero_tracer",)),
    "zero_layer_kord3": (3, 2, HOST_KM, ("zero_layer",)),
    "zero_layer_kord4": (4, 2, HOST_KM, ("zero_layer",)),
    "target_on_source": (4, 2, HOST_KM, ("on_source",)),
    "fewer_targets": (3, 2, 7, ()),
    "more_targets": (4, 2, 13, ("on_source",)),
}


def _host_inputs(kord, nf, km_t, extra, seed):
    """te_map-like (k, ncol) inputs: six monotone interface sets sharing
    their end points, pt-like center fields, a tracer, u and v."""
    rng = np.random.default_rng(seed)
    km, ncol = HOST_KM, HOST_NCOL
    pes = [_interfaces(rng, n, ncol, j) for n, j in
           ((km, 0.3), (km_t, 0.1), (km, 0.3), (km_t, 0.2), (km, 0.3),
            (km_t, 0.1))]
    if "zero_layer" in extra:
        # zero-thickness source layers, none adjacent to another: at the
        # top, inside and at the bottom of the column, each in some columns
        for src in pes[0::2]:
            src[1, :8] = src[0, :8]
            src[5, 10:25] = src[4, 10:25]
            src[km - 1, 30:] = src[km, 30:]
    if "on_source" in extra:
        # targets exactly on source interfaces in every other column
        for src, tgt in zip(pes[0::2], pes[1::2]):
            n = min(km, km_t)
            tgt[2:n - 1, ::2] = src[2:n - 1, ::2]
            tgt[:] = np.sort(tgt, axis=0)
    fields = [250.0 + 30.0 * rng.standard_normal((km, ncol))]
    fields += [rng.uniform(0.0, 1e-2, (km, ncol)) for _ in range(nf - 1)]
    if "zero_tracer" in extra:
        fields[-1] = np.zeros((km, ncol))
    u = 10.0 * rng.standard_normal((km, ncol))
    v = 10.0 * rng.standard_normal((km, ncol))
    return pes, fields, u, v


@pytest.fixture(scope="module")
def remap_host_lib(tmp_path_factory):
    return host_build("remap_kernels", tmp_path_factory.mktemp("remap_host"),
                      1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(HOST_CASES))
def test_cuda_source_bitwise_on_the_host(case, dtype, remap_host_lib):
    """csrc/remap_kernels.cu built for the host, through the wrapper's own
    launch function, against te_map_remap_ref: every output bitwise equal
    (one launch a call for all fields)."""
    kord, nf, km_t, extra = HOST_CASES[case]
    pes, fields, u, v = _host_inputs(kord, nf, km_t, extra,
                                     seed=list(HOST_CASES).index(case))
    if "zero_layer" in extra:
        assert (np.diff(pes[0], axis=0) == 0.0).any()
    if "on_source" in extra:
        assert np.isin(pes[1][1:-1], pes[0][1:-1]).any()

    def ten(a):
        return torch.from_numpy(a).to(dtype)

    pe = [ten(p) for p in pes]
    cen = [ten(f) for f in fields]
    want = trk.te_map_remap_ref(*pe, cen, ten(u), ten(v), kord)
    suf = "f32" if dtype == torch.float32 else "f64"
    n0 = remap_host_lib.cam_host_launches()
    got = trk._run(getattr(remap_host_lib, f"cam_te_map_remap_{suf}"), None,
                   *pe, torch.stack(cen), ten(u), ten(v), kord)
    assert remap_host_lib.cam_host_launches() - n0 == 1
    names = [f"center[{i}]" for i in range(nf)] + ["u", "v"]
    for name, g, w in zip(names, got[0] + [got[1], got[2]],
                          want[0] + [want[1], want[2]]):
        assert g.shape == (km_t, HOST_NCOL), name
        assert torch.isfinite(w).all(), name
        err = float((g - w).abs().max())
        assert err == 0.0, f"{case} {dtype} {name}: max abs error {err:.3e}"


# Columns the walk's argument does not cover (csrc/remap_kernels.cu,
# "Exactness"), each (kord, what the inputs hold). In te_map_remap_ref:
# - "nan": a NaN pt value (column 3, cell 8) and a NaN v (column 11, cell
#   6), below every target but the last ones: every output of those two
#   columns is NaN (0 * NaN in each target's sum; the bottom's total too);
# - "inf": an inf tracer value (column 20, cell 8) and an inf interface of
#   u's source set (column 5, interface 8): every output of those columns
#   NaN (0 * inf below a target, inf - inf after it);
# - "crossed": pe_s's interfaces 4 and 5 swapped in column 5, pe_t's 3 and
#   4 in column 9, u's target interfaces 6 and 7 in column 13: finite
#   outputs that the walk's running sum alone would not give.
# Every other column stays finite.
ODD_COLUMNS = {"nan": {"center[0]": [3], "v": [11]},
               "inf": {"center[1]": [20], "u": [5]},
               "crossed": {}}
ODD_CASES = {"nan_kord2": (2, "nan"), "nan_kord3": (3, "nan"),
             "nan_kord4": (4, "nan"), "inf_kord4": (4, "inf"),
             "crossed_kord3": (3, "crossed"),
             "crossed_kord4": (4, "crossed")}


def _odd_inputs(kord, what, seed):
    """_host_inputs with the non-finite values or crossed interfaces of
    ODD_COLUMNS[what]."""
    pes, fields, u, v = _host_inputs(kord, 2, HOST_KM, (), seed)
    if what == "nan":
        fields[0][8, 3] = np.nan
        v[6, 11] = np.nan
    elif what == "inf":
        fields[1][8, 20] = np.inf
        pes[2][8, 5] = np.inf
    else:
        pes[0][[4, 5], 5] = pes[0][[5, 4], 5]
        pes[1][[3, 4], 9] = pes[1][[4, 3], 9]
        pes[3][[6, 7], 13] = pes[3][[7, 6], 13]
    return pes, fields, u, v


def _same_bits(got, want, names, label):
    """NaN exactly where `want` has NaN, every other value equal."""
    for name, g, w in zip(names, got, want):
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan), f"{label} {name}: NaN"
        err = float((g[~nan] - w[~nan]).abs().max())
        assert err == 0.0, f"{label} {name}: max abs error {err:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(ODD_CASES))
def test_cuda_source_matches_plain_on_odd_columns_on_the_host(
        case, dtype, remap_host_lib):
    """csrc/remap_kernels.cu built for the host against te_map_remap_ref
    on non-finite values below a target and on crossed interfaces: NaN
    where the plain version has NaN, bitwise elsewhere. The plain
    version's NaN columns are the ones ODD_COLUMNS names, all of their
    outputs."""
    kord, what = ODD_CASES[case]
    pes, fields, u, v = _odd_inputs(kord, what, list(ODD_CASES).index(case))

    def ten(a):
        return torch.from_numpy(a).to(dtype)

    pe = [ten(p) for p in pes]
    cen = [ten(f) for f in fields]
    want = trk.te_map_remap_ref(*pe, cen, ten(u), ten(v), kord)
    suf = "f32" if dtype == torch.float32 else "f64"
    got = trk._run(getattr(remap_host_lib, f"cam_te_map_remap_{suf}"), None,
                   *pe, torch.stack(cen), ten(u), ten(v), kord)
    names = ["center[0]", "center[1]", "u", "v"]
    want = want[0] + [want[1], want[2]]
    for name, w in zip(names, want):
        cols = torch.isnan(w).any(0).nonzero().flatten().tolist()
        assert cols == ODD_COLUMNS[what].get(name, []), (name, cols)
        assert torch.isnan(w[:, cols]).all(), name
    _same_bits(got[0] + [got[1], got[2]], want, names, case)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(ODD_CASES))
def test_cuda_kernel_matches_plain_on_odd_columns_on_the_card(case, dtype):
    """The kernel itself on ODD_CASES' inputs: NaN where te_map_remap_ref
    has NaN, bitwise elsewhere, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    kord, what = ODD_CASES[case]
    pes, fields, u, v = _odd_inputs(kord, what, list(ODD_CASES).index(case))

    def ten(a):
        return torch.from_numpy(a).to("cuda", dtype)

    args = [ten(p) for p in pes] + [[ten(f) for f in fields], ten(u),
                                     ten(v), kord]
    n0 = trk.te_map_remap.launches
    got = trk.te_map_remap(*args)
    want = trk.te_map_remap_ref(*args)
    torch.cuda.synchronize()
    assert trk.te_map_remap.launches == n0 + 1
    _same_bits([g.cpu() for g in got[0] + [got[1], got[2]]],
               [w.cpu() for w in want[0] + [want[1], want[2]]],
               ["center[0]", "center[1]", "u", "v"], case)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(HOST_CASES))
def test_cuda_kernel_bitwise_on_the_card(case, dtype):
    """The kernel itself on HOST_CASES' inputs: bitwise equal to
    te_map_remap_ref, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    kord, nf, km_t, extra = HOST_CASES[case]
    pes, fields, u, v = _host_inputs(kord, nf, km_t, extra,
                                     seed=list(HOST_CASES).index(case))

    def ten(a):
        return torch.from_numpy(a).to("cuda", dtype)

    args = [ten(p) for p in pes] + [[ten(f) for f in fields], ten(u),
                                     ten(v), kord]
    n0 = trk.te_map_remap.launches
    got = trk.te_map_remap(*args)
    want = trk.te_map_remap_ref(*args)
    torch.cuda.synchronize()
    assert trk.te_map_remap.launches == n0 + 1
    for g, w in zip(got[0] + [got[1], got[2]], want[0] + [want[1], want[2]]):
        assert float((g - w).abs().max()) == 0.0, case
