"""Gradients through the port's geometry path against ``jax.grad`` of the
JAX package's XLA path: perimeters (K7's Function), windowed lengths
(K8's Function) and ``clength_pipeline`` (K2's Function, the grad-safe
divisions).

Same numpy inputs in float64 on both sides; the non-finite pattern must be
equal and the values within rtol=1e-8, atol=1e-12 of the largest |gradient|
(the JAX suite's Pallas-against-XLA bound, tests/test_differentiable.py).
On the CPU each Function's forward is its kernel's plain version and its
backward the same code that runs on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import core as jcore
from xcontour_tpu import grid as jgrid
from xcontour_tpu import pipeline as jpipe
from xcontour_tpu.diagnostics.length import contour_lengths as jlengths
from xcontour_tpu.diagnostics.local_length import local_contour_lengths as jlocal
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.kernels import hist, length

CPU = "cpu"


def assert_grad_equal(got, want, nonzero=True):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(want)
    scale = np.abs(want[m]).max() if m.any() else 0.0
    if nonzero:
        assert scale > 0
    np.testing.assert_allclose(got[m], want[m], rtol=1e-8, atol=1e-12 * scale)


def torch_grad(loss, x):
    t = torch.tensor(x, requires_grad=True)
    g, = torch.autograd.grad(loss(t), t)
    return g


def _field(seed, Ny, Nx, lat0, noise):
    rng = np.random.default_rng(seed)
    lat = np.linspace(-lat0, lat0, Ny)
    return lat, np.sin(np.deg2rad(lat))[:, None] + noise * rng.standard_normal(
        (Ny, Nx))


@pytest.mark.parametrize("latlon", [True, False])
def test_lengths_at_pinned_levels_match_jax(latlon):
    """Fault A: levels from cal_contours are pinned to the field's extrema
    and make zero-length segments through cell corners, where hypot's and
    arcsin(sqrt(a))'s jacobians are 0/0.  The twin's grad-safe forms give
    the zero subgradient there (without them every cell's gradient is
    NaN)."""
    lat, data = _field(0, 20, 30, 60.0, 0.3)
    lon = np.linspace(0.0, 348.0, 30)

    def jloss(d):
        ctr = jcore.cal_contours(d[None], 9, increase=True)
        return jnp.nansum(jlengths(d[None], ctr, jnp.asarray(lat),
                                   jnp.asarray(lon), latlon=latlon))

    def tloss(d):
        ctr = xt.cal_contours(d[None], 9, increase=True)
        return torch.nansum(xt.contour_lengths(
            d[None], ctr, torch.tensor(lat), torch.tensor(lon), latlon=latlon))

    want = jax.grad(jloss)(jnp.asarray(data))
    assert np.isfinite(np.asarray(want)).all()
    assert_grad_equal(torch_grad(tloss, data), want)


def test_clength_unused_channels_carry_no_cotangent():
    """Fault B: clength_pipeline digitizes its five channels in one K2
    launch.  Zero cotangents of the channels the loss does not use must
    not pass through sqrt(grdS) and 1/grdm at NaN cells (0 * NaN), which
    would add four non-finite cells to JAX's 47."""
    lat, data = _field(1, 16, 24, 70.0, 0.2)
    lon = np.linspace(0.0, 345.0, 24)
    data[3:6, 4:9] = np.nan
    jg = jgrid.from_latlon(lat, lon, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)

    def jloss(d):
        L = jpipe.clength_pipeline(d[None], jg, N=9)["Leq2"]
        return jnp.nansum(jnp.where(jnp.isfinite(L), L, 0.0))

    def tloss(d):
        L = xt.clength_pipeline(d[None], tg, N=9)["Leq2"]
        return torch.nansum(torch.where(torch.isfinite(L), L,
                                        torch.zeros_like(L)))

    want = jax.grad(jloss)(jnp.asarray(data))
    assert (~np.isfinite(np.asarray(want))).sum() == 47
    assert_grad_equal(torch_grad(tloss, data), want)


def test_clength_gradient_of_every_output_matches_jax():
    """Every clength output (the contour means too) in one loss."""
    lat, data = _field(2, 16, 24, 70.0, 0.2)
    lon = np.linspace(0.0, 345.0, 24)
    data[9:11, 14:17] = np.nan
    jg = jgrid.from_latlon(lat, lon, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    keys = ("lengths", "Leq2", "cmGrd", "cmInvGrd", "Yeq", "Lmin")

    def jloss(d):
        out = jpipe.clength_pipeline(d[None], jg, N=11)
        return sum(jnp.nansum(jnp.where(jnp.isfinite(out[k]), out[k], 0.0))
                   / jnp.nanmax(jnp.abs(jax.lax.stop_gradient(out[k])))
                   for k in keys)

    def tloss(d):
        out = xt.clength_pipeline(d[None], tg, N=11)
        return sum(torch.nansum(torch.where(torch.isfinite(out[k]), out[k],
                                            torch.zeros_like(out[k])))
                   / torch.nan_to_num(out[k].detach().abs(), nan=0.0).max()
                   for k in keys)

    assert_grad_equal(torch_grad(tloss, data), jax.grad(jloss)(jnp.asarray(data)))


LENGTH_CASES = [
    # latlon, NaN patch, levels
    (True, False, "fixed"),
    (False, False, "fixed"),
    (True, True, "fixed"),
    (False, True, "fixed"),
    (True, False, "nan"),
]


@pytest.mark.parametrize("latlon,patch,levels", LENGTH_CASES)
def test_contour_length_gradients_match_jax(latlon, patch, levels):
    """Perimeters at fixed levels, lat-lon and planar, with a NaN patch,
    and a NaN level (all-NaN batch elements give those)."""
    lat, data = _field(3, 20, 30, 60.0, 0.3)
    lon = np.linspace(0.0, 348.0, 30)
    if patch:
        data[5:8, 10:14] = np.nan
    ctr = np.linspace(-0.8, 0.8, 9) if levels == "fixed" else \
        np.array([0.0, np.nan])

    def jloss(d):
        return jnp.nansum(jlengths(d[None], jnp.asarray(ctr), jnp.asarray(lat),
                                   jnp.asarray(lon), latlon=latlon))

    def tloss(d):
        return torch.nansum(xt.contour_lengths(
            d[None], torch.tensor(ctr), torch.tensor(lat), torch.tensor(lon),
            latlon=latlon))

    assert_grad_equal(torch_grad(tloss, data), jax.grad(jloss)(jnp.asarray(data)))


def test_contour_length_level_and_batch_gradients_match_jax():
    """The cotangent of per-element levels, over a batch of three, against
    JAX's, a backward chunk of levels at a time smaller than the forward's."""
    rng = np.random.default_rng(4)
    lat = np.linspace(-60.0, 60.0, 14)
    lon = np.linspace(0.0, 340.0, 18)
    data = np.sin(np.deg2rad(lat))[None, :, None] + 0.3 * rng.standard_normal(
        (3, 14, 18))
    ctr = np.sort(rng.uniform(-0.7, 0.7, (3, 11)), axis=-1)

    def jloss(d, c):
        return jnp.nansum(jlengths(d, c, jnp.asarray(lat), jnp.asarray(lon),
                                   latlon=True) ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(data), jnp.asarray(ctr))
    t = torch.tensor(data, requires_grad=True)
    c = torch.tensor(ctr, requires_grad=True)
    L = xt.contour_lengths(t, c, torch.tensor(lat), torch.tensor(lon),
                           latlon=True, chunk=4)
    got = torch.autograd.grad(torch.nansum(L ** 2), (t, c))
    for g, w in zip(got, want):
        assert_grad_equal(g, w)


@pytest.mark.parametrize("latlon", [True, False])
def test_local_length_gradients_match_jax(latlon):
    """Windowed lengths, window 7 and stride 4, at the rolling-mean levels
    (so the gradient also flows through the levels)."""
    lat, data = _field(5, 16, 24, 60.0, 0.3)
    lon = np.linspace(0.0, 345.0, 24)
    data[10, 3] = np.nan

    def jloss(d):
        L, _, _ = jlocal(d, jnp.asarray(lat), jnp.asarray(lon), window=7,
                         stride=4, latlon=latlon)
        return jnp.nansum(L)

    def tloss(d):
        L, _, _ = xt.local_contour_lengths(d, torch.tensor(lat),
                                           torch.tensor(lon), window=7,
                                           stride=4, latlon=latlon)
        return torch.nansum(L)

    assert_grad_equal(torch_grad(tloss, data), jax.grad(jloss)(jnp.asarray(data)))


def test_geometry_wrappers_run_as_often_with_gradients(monkeypatch):
    """With gradients, clength_pipeline still calls the K2 wrapper once a
    step (one digitize for its five channels) and the K7 wrapper once;
    local_contour_lengths the K8 wrapper once; the backwards call no
    wrapper."""
    calls = {}

    def count(mod, name):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    count(hist, "weighted_cdf")
    count(length, "contour_lengths")
    count(length, "local_lengths")
    lat, data = _field(6, 16, 24, 70.0, 0.2)
    lon = np.linspace(0.0, 345.0, 24)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    table = xt.cal_area_eqCoord_table_hist(tg.fluid_mask(torch.float64),
                                           tg.ydef, tg.dA, increase=True,
                                           lt=True)
    seen = []
    for grad in (False, True):
        calls.clear()
        t = torch.tensor(data[None], requires_grad=grad)
        out = xt.clength_pipeline(t, tg, N=9, table=table)
        L, _, _ = xt.local_contour_lengths(t[0], tg.ydef, tg.xdef, window=7,
                                           stride=4)
        if grad:
            loss = (torch.nansum(out["Leq2"]) + torch.nansum(out["cmGrd"])
                    + torch.nansum(out["lengths"]) + torch.nansum(L))
            g, = torch.autograd.grad(loss, t)
            assert torch.isfinite(g).any()
        seen.append(dict(calls))
    assert seen[0] == seen[1] == dict(weighted_cdf=1, contour_lengths=1,
                                      local_lengths=1)
