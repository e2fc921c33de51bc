"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The port's tests feed the same numpy inputs, made from a seeded
np.random.default_rng, to a JAX function and to its twin in
cam_nor_physics_tpu_torch, on the CPU in float64, and compare the outputs
with a tolerance relative to each output's largest magnitude.
"""

import numpy as np
import torch


def t64(a):
    """numpy -> float64 CPU tensor (bool arrays stay bool)."""
    a = np.array(a)
    return torch.from_numpy(a if a.dtype == bool else a.astype(np.float64))


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, tol, name="", scale=None):
    """|got - want| <= tol·|want| + tol·scale elementwise; `scale` defaults
    to max|want|."""
    got, want = npy(got), npy(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=name)


def slab_fields(km, jm, im, seed, ffsl_rows=3, cmax=0.9, cmax_ffsl=2.5):
    """Random-but-smooth (km, jm, im) transport inputs with an FV-like
    latitude structure: |crx| up to `cmax_ffsl` in `ffsl_rows` rows next to
    each pole (the FFSL branch), up to `cmax` elsewhere."""
    rng = np.random.default_rng(seed)
    dp = np.pi / (jm - 1)
    lat = -0.5 * np.pi + dp * np.arange(jm)
    x = 2.0 * np.pi * np.arange(im) / im
    smooth = np.sin(x)[None, None, :] * np.cos(lat)[None, :, None]
    delp = 1.0 + 0.3 * smooth + 0.1 * rng.uniform(size=(km, jm, im))
    pt = 300.0 + 20.0 * smooth + 5.0 * rng.standard_normal((km, jm, im))
    crx = rng.uniform(-cmax, cmax, (km, jm, im))
    polar = list(range(1, 1 + ffsl_rows)) + \
        list(range(jm - 1 - ffsl_rows, jm - 1))
    crx[:, polar] = rng.uniform(-cmax_ffsl, cmax_ffsl,
                                (km, len(polar), im))
    crx[:, 0] = crx[:, -1] = 0.0
    cry = rng.uniform(-0.5, 0.5, (km, jm, im))
    cry[:, 0] = 0.0
    return dict(delp=delp, pt=pt, crx=crx, cry=cry,
                zeta=1e-4 * rng.standard_normal((km, jm, im)),
                q=rng.uniform(0.0, 1e-2, (2, km, jm, im)))
