"""K8 (windowed local lengths) and ``local_contour_lengths``: the port
against the JAX package on the same numpy inputs.

Tolerances: float64 rolling means 1e-12 relative; the float32 rolling mean
of a Kelvin-offset field 3e-6 relative to the float64 direct window mean
(``tests/test_local_length.py``'s bound); the K8 plain version against the
XLA twin ``_local_totals_xla_raw`` 1e-12 relative, against the TPU kernel
in interpret mode rtol 2e-7 (its series geodesics); float32
``local_contour_lengths`` 2e-6 of the largest length.  NaN patterns agree
exactly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import config
from xcontour_tpu.diagnostics import local_length as jlocal
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.diagnostics import local_length as tlocal
from xcontour_tpu_torch.kernels import length as k8

lk = importlib.import_module("xcontour_tpu.kernels.length_pallas")


def _field(seed, Ny=40, Nx=56):
    rng = np.random.default_rng(seed)
    d = np.cumsum(rng.normal(size=(Ny, Nx)), axis=0) + 0.5 * rng.normal(size=(Ny, Nx))
    d[6:9, 20:26] = np.nan
    lat = np.linspace(-70.0, 70.0, Ny)
    lon = np.linspace(0.0, 357.0, Nx)
    return lat, lon, d


def _rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    scale = np.abs(want[m]).max() if m.any() else 1.0
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=rtol * scale)


def _with_pallas_interpret(fn):
    """Run ``fn`` with the JAX package's Pallas path on, its window kernel
    in interpret mode; both restored afterwards."""
    orig = lk.local_lengths_pallas
    lk.local_lengths_pallas = lambda *a, **k: orig(
        *a, interpret=True, **{kk: v for kk, v in k.items() if kk != "interpret"})
    config.set_use_pallas(True)
    try:
        return fn()
    finally:
        config.set_use_pallas(None)
        lk.local_lengths_pallas = orig


@pytest.mark.parametrize("window,stride,min_count", [(11, 5, 20), (8, 3, 1)])
def test_rolling_mean_matches_jax(window, stride, min_count):
    _, _, d = _field(1)
    want, oy, ox = jlocal.rolling_mean(jnp.asarray(d), window, stride, min_count)
    got, toy, tox = tlocal.rolling_mean(torch.as_tensor(d), window, stride,
                                        min_count)
    np.testing.assert_array_equal(toy.numpy(), np.asarray(oy))
    np.testing.assert_array_equal(tox.numpy(), np.asarray(ox))
    _rel_close(got.numpy(), want, 1e-12)


def test_rolling_mean_f32_offset_field():
    """A Kelvin-scale offset must not degrade the float32 window mean."""
    rng = np.random.default_rng(2)
    Ny, Nx, w = 256, 512, 64
    f = 300.0 + rng.normal(size=(Ny, Nx))
    got, oy, ox = xt.rolling_mean(torch.as_tensor(f, dtype=torch.float32), w, 32)
    want = np.array([[f[y0:y0 + w, x0:x0 + w].mean() for x0 in ox.tolist()]
                     for y0 in oy.tolist()])
    err = np.abs(got.numpy().astype(np.float64) - want) / np.abs(want)
    assert err.max() < 3e-6, err.max()


@pytest.mark.parametrize("latlon", [True, False])
def test_plain_matches_twin_and_pallas_interpret(latlon):
    lat, lon, d = _field(3)
    window, stride = 13, 6
    yc = np.deg2rad(lat) if latlon else lat * 1e4
    xc = np.deg2rad(lon) if latlon else lon * 1e4
    means, oy, ox = jlocal.rolling_mean(jnp.asarray(d), window, stride)
    levels = np.array(means)
    levels[1, 2] = np.nan                          # a NaN level
    want = np.asarray(jlocal._local_totals_xla_raw(
        jnp.asarray(d), jnp.asarray(levels), jnp.asarray(yc), jnp.asarray(xc),
        window=window, stride=stride, latlon=latlon))
    got = k8.local_lengths(*(torch.as_tensor(a) for a in (d, levels, yc, xc)),
                           window=window, stride=stride, latlon=latlon).numpy()
    finite = np.isfinite(levels)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-12)
    assert np.all(got[~finite] == 0.0)             # evaluated at 0, zeroed
    # the TPU kernel, on the patch stack its launcher builds
    Wy, Wx = levels.shape
    patches = np.stack([d[y0:y0 + window, x0:x0 + window]
                        for y0 in np.asarray(oy) for x0 in np.asarray(ox)])
    ywin = np.stack([yc[y0:y0 + window] for y0 in np.asarray(oy)
                     for _ in range(Wx)])
    xwin = np.stack([xc[x0:x0 + window] for _ in range(Wy)
                     for x0 in np.asarray(ox)])
    tpu = np.asarray(lk.local_lengths_pallas(
        jnp.asarray(patches), jnp.asarray(levels.reshape(-1)),
        jnp.asarray(ywin), jnp.asarray(xwin), latlon=latlon,
        interpret=True)).reshape(Wy, Wx)
    np.testing.assert_allclose(got[finite], tpu[finite], rtol=2e-7, atol=1e-12)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
def test_local_contour_lengths_matches_jax(dt, jax_path):
    jdt, tdt = (jnp.float64, torch.float64) if dt == "f64" else \
        (jnp.float32, torch.float32)
    lat, lon, d = _field(4)
    kw = dict(window=15, stride=7, latlon=True, min_count=10)
    call = lambda: jlocal.local_contour_lengths(
        jnp.asarray(d, jdt), jnp.asarray(lat, jdt), jnp.asarray(lon, jdt), **kw)
    want, cy, cx = _with_pallas_interpret(call) if jax_path == "pallas" \
        else call()
    got, ty, tx = xt.local_contour_lengths(
        *(torch.as_tensor(a).to(tdt) for a in (d, lat, lon)), **kw)
    assert got.dtype == tdt
    np.testing.assert_array_equal(ty.numpy(), np.asarray(cy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(cx))
    # the TPU kernel's series geodesics differ from the twin by ~1e-7
    rtol = 2e-6 if dt == "f32" else (2e-7 if jax_path == "pallas" else 1e-12)
    _rel_close(got.numpy(), want, rtol)


def test_zonal_ratio_invariant():
    """For a zonal tracer the local contour is the latitude line through
    the window centre: its ratio to that line's length (window - 1 cells of
    2 R asin(cos(lat) sin(dlon / 2))) is 1."""
    from xcontour_tpu_torch.utils.constants import Rearth
    lat = np.linspace(-60, 60, 61)
    lon = np.linspace(0, 358, 90)
    f = np.broadcast_to(lat[:, None], (61, 90)).copy()
    num, cy, _ = xt.local_contour_lengths(
        torch.as_tensor(f), torch.as_tensor(lat), torch.as_tensor(lon),
        window=21, stride=10, latlon=True)
    dlon = np.deg2rad(lon[1] - lon[0])
    line = 20 * 2 * Rearth * np.arcsin(np.cos(np.deg2rad(cy.numpy()))
                                       * np.sin(dlon / 2))
    ratio = num.numpy() / line[:, None]
    assert np.isfinite(ratio).all() and np.abs(ratio - 1).max() < 1e-9


def window_minimum_case():
    """64 windows of 9 x 9 cells (10 points, stride 10) of a seeded field,
    each at its own minimum."""
    rng = np.random.default_rng(7)
    d = rng.normal(size=(80, 80)) * rng.uniform(0.1, 1000.0) \
        + rng.uniform(-50.0, 50.0)
    levels = d.reshape(8, 10, 8, 10).min(axis=(1, 3))
    return np.linspace(-60.0, 60.0, 80), np.linspace(0.0, 300.0, 80), d, levels


def test_window_minimum_tie_follows_the_twin():
    """At its own minimum each window is empty: the twin gives NaN in every
    window, the TPU kernel (reciprocal edge fractions) leaves ulps of
    length in some, the port follows the twin in float64 and float32."""
    lat, lon, d, levels = window_minimum_case()
    kw = dict(window=10, stride=10, latlon=True)
    want, _, _ = jlocal.local_contour_lengths(
        jnp.asarray(d), jnp.asarray(lat), jnp.asarray(lon),
        levels=jnp.asarray(levels), **kw)
    assert np.all(np.isnan(np.asarray(want)))
    tpu = _with_pallas_interpret(lambda: jlocal.local_contour_lengths(
        jnp.asarray(d, jnp.float32), jnp.asarray(lat, jnp.float32),
        jnp.asarray(lon, jnp.float32), levels=jnp.asarray(levels, jnp.float32),
        **kw)[0])
    assert np.count_nonzero(np.isfinite(np.asarray(tpu))) > 0  # the fault
    for dt in (np.float64, np.float32):
        t = [torch.as_tensor(a.astype(dt)) for a in (d, lat, lon, levels)]
        got, _, _ = xt.local_contour_lengths(t[0], t[1], t[2], levels=t[3], **kw)
        assert torch.isnan(got).all()
        raw = k8.local_lengths(t[0], t[3], torch.deg2rad(t[1]),
                               torch.deg2rad(t[2]), **kw)
        assert (raw == 0).all()
