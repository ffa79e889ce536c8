"""Gradients through the port's Keff chain against ``jax.grad`` of the JAX
package's XLA path: the grad-safe divisions of the Keff tail, the Keff
flag matrix, the second order (Hessian-vector products), and the rule that
a call needing no gradient goes through no autograd Function.

Same numpy inputs in float64 on both sides; the non-finite pattern must be
equal and the values within rtol=1e-8, atol=1e-12 of the largest |gradient|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import core as jcore
from xcontour_tpu import grid as jgrid
from xcontour_tpu import pipeline as jpipe
import xcontour_tpu_torch as xt
from xcontour_tpu_torch import core as tcore
from xcontour_tpu_torch.diagnostics import length as dlength
from xcontour_tpu_torch.diagnostics import local_length as dlocal
from xcontour_tpu_torch.diagnostics import lwa as dlwa
from xcontour_tpu_torch.kernels import (boxcount, hist, length, lwa, rolling,
                                        stencil)
from xcontour_tpu_torch.ops import histogram as ohist
from xcontour_tpu_torch.ops import stencil as ostencil

CPU = "cpu"
FUNCTIONS = [tcore._GradSafeDiv, tcore._GradSafeDivSq, ohist._WeightedCDF,
             ostencil._SquaredGradient, dlwa._LWA, dlength._ContourLengths,
             dlocal._LocalLengths, dlocal._WindowMeans]


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


def _grids(lat, lon):
    return (jgrid.from_latlon(lat, lon, dtype=jnp.float64),
            xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU))


def test_grad_safe_div_matches_jax():
    """test_grad_safe_div_primal_matches_raw_division's arrays: the primal
    equals the plain division bit for bit (0/0, x/0, NaN and inf
    operands), the cotangents equal JAX's and are finite."""
    num = np.array([1.0, 0.0, -2.0, np.nan, 3.0, 0.0, np.inf, 1.0, np.inf])
    den = np.array([2.0, 0.0, 0.0, 1.0, np.nan, 0.0, 2.0, np.inf, np.inf])
    with np.errstate(invalid="ignore", divide="ignore"):
        raw = num / den
    a = torch.tensor(num, requires_grad=True)
    b = torch.tensor(den, requires_grad=True)
    out = tcore.grad_safe_div(a, b)
    np.testing.assert_array_equal(out.detach().numpy(), raw)
    loss = torch.nansum(torch.where(torch.isfinite(out), out,
                                    torch.zeros_like(out)))
    got = torch.autograd.grad(loss, (a, b))

    def jloss(x, y):
        o = jcore._grad_safe_div(x, y)
        return jnp.nansum(jnp.where(jnp.isfinite(o), o, 0.0))
    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(num), jnp.asarray(den))
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        assert_grad_equal(g, w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grad_safe_div_sq_matches_jax(dtype):
    """The fused n/d^2 form: the primal equals num / (den * den) bit for
    bit, finite cotangents equal to JAX's where den^2 underflows (primal
    inf with den != 0) and on inf/inf."""
    num = np.array([1.0, 1.0, np.inf, 2.0, -3.0], dtype)
    den = np.array([1e-25, 1.0, np.inf, 3.0, 0.5], dtype)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        want_p = num / (den * den)
    a = torch.tensor(num, requires_grad=True)
    b = torch.tensor(den, requires_grad=True)
    out = tcore.grad_safe_div_sq(a, b)
    np.testing.assert_array_equal(out.detach().numpy(), want_p)
    loss = torch.nansum(torch.where(torch.isfinite(out), out,
                                    torch.zeros_like(out)))
    got = torch.autograd.grad(loss, (a, b))

    def jloss(x, y):
        o = jcore._grad_safe_div_sq(x, y)
        return jnp.nansum(jnp.where(jnp.isfinite(o), o, 0.0))
    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(num), jnp.asarray(den))
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        assert_grad_equal(g, w)


def _keff_flags(n, seed):
    rng = np.random.default_rng(seed)
    return [(bool(rng.integers(2)), bool(rng.integers(2)),
             bool(rng.integers(2)), ["analytic", "dxF", "frac"][rng.integers(3)])
            for _ in range(n)]


KEFF_FLAGS = _keff_flags(8, 3)


@pytest.mark.parametrize("trial", range(len(KEFF_FLAGS)))
def test_keff_flag_matrix_gradients_match_jax(trial):
    """test_keff_grad_flag_matrix_fuzz's 8 trials of keff_pipeline
    (increase, lt, hist, lmin): the gradient of nansum(nkeff)."""
    increase, lt, hist_path, lmin = KEFF_FLAGS[trial]
    rng = np.random.default_rng(200 + trial)
    Ny, Nx = 16, 24
    lat = np.linspace(-70, 70, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    jg, tg = _grids(lat, lon)
    base = np.sin(np.deg2rad(lat))[:, None] + 0.15 * np.cos(
        3 * np.deg2rad(lon))[None, :] * np.cos(np.deg2rad(lat))[:, None]
    if not increase:
        base = -base
    v = base + 0.02 * rng.standard_normal((Ny, Nx))
    kw = dict(N=15, increase=increase, lt=lt, hist=hist_path, lmin=lmin)

    def jloss(t):
        return jnp.nansum(jpipe.keff_pipeline(t[None], jg, **kw)
                          ["origin"]["nkeff"])
    want = jax.grad(jloss)(jnp.asarray(v))
    t = torch.tensor(v, requires_grad=True)
    loss = torch.nansum(xt.keff_pipeline(t[None], tg, **kw)["origin"]["nkeff"])
    got, = torch.autograd.grad(loss, t)
    assert_grad_equal(got, want)


def _hvp_setup():
    rng = np.random.default_rng(50)
    Ny, Nx = 16, 24
    lat = np.linspace(-60.0, 60.0, Ny)
    lon = np.linspace(0.0, 345.0, Nx)
    q = np.sin(np.deg2rad(lat))[:, None] + 0.2 * rng.standard_normal((Ny, Nx))
    return lat, lon, q, rng.standard_normal(q.shape)


def test_second_order_hvp_matches_fd_and_jax():
    """test_second_order_hvp_matches_fd: reverse-over-reverse Hessian-
    vector products of the Keff+LWA step through every Function (K1, K2,
    LWA and the grad-safe divisions, each backward recomputed on the
    saved inputs) match central differences of the gradient (< 1e-6 of
    the largest) and JAX's."""
    lat, lon, q, v = _hvp_setup()
    jg, tg = _grids(lat, lon)

    def tloss(t):
        nk = xt.keff_lwa_pipeline(t[None], tg, N=9, increase=True,
                                  lt=True)["nkeff"]
        return torch.nansum(torch.where(torch.isfinite(nk), nk,
                                        torch.zeros_like(nk))) * 1e-6

    def tgrad(x, create=False):
        t = x if create else torch.tensor(x, requires_grad=True)
        g, = torch.autograd.grad(tloss(t), t, create_graph=create)
        return g

    t = torch.tensor(q, requires_grad=True)
    vt = torch.tensor(v)
    g = tgrad(t, create=True)
    hvp, = torch.autograd.grad(torch.sum(g * vt), t)
    hvp = hvp.numpy()
    assert np.isfinite(hvp).all()
    eps = 1e-5
    fd = (tgrad(q + eps * v) - tgrad(q - eps * v)).numpy() / (2 * eps)
    denom = np.abs(fd).max()
    assert denom > 0
    assert np.abs(hvp - fd).max() / denom < 1e-6

    def jloss(x):
        nk = jpipe.keff_lwa_pipeline(x[None], jg, N=9, increase=True,
                                     lt=True)["nkeff"]
        return jnp.nansum(jnp.where(jnp.isfinite(nk), nk, 0.0)) * 1e-6
    want = jax.grad(lambda x: jnp.vdot(jax.grad(jloss)(x), jnp.asarray(v)))(
        jnp.asarray(q))
    assert_grad_equal(torch.tensor(hvp), want)


def _count_wrappers(monkeypatch):
    calls = {}
    for mod, name in ((stencil, "squared_gradient"), (hist, "weighted_cdf"),
                      (lwa, "lwa_lin"), (lwa, "lwa_lin2"), (lwa, "lwa_dense"),
                      (length, "contour_lengths"), (length, "local_lengths"),
                      (boxcount, "box_counts"), (rolling, "window_means")):
        def wrapped(*a, _orig=getattr(mod, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


def _every_path(q, grid):
    """One call of each entry point that runs a kernel; the outputs that
    carry a gradient, summed."""
    parts = []
    for method in ("auto", "dense"):
        out = xt.keff_lwa_pipeline(q, grid, N=9, lwa_method=method,
                                   with_lwa2=True)
        parts += [out["lwa"], out["lwa2"], out["Leq2"]]
    out = xt.lwa_pipeline(q, grid, N=9, part="upper")
    parts += [out["lwa"], out["lwa2"]]
    parts.append(xt.keff_pipeline(q, grid, N=9)["origin"]["nkeff"])
    out = xt.clength_pipeline(q, grid, N=9)
    parts += [out["lengths"], out["cmInvGrd"]]
    out = xt.fractal_pipeline(q, grid, N=9, strides=(1, 2))
    parts.append(out["lengths"])
    parts.append(xt.local_contour_lengths(q[0], grid.ydef, grid.xdef,
                                          window=5, stride=3)[0])
    return sum(torch.nansum(torch.where(torch.isfinite(p), p,
                                        torch.zeros_like(p)))
               for p in parts)


def test_no_function_without_gradients_and_same_wrapper_calls(monkeypatch):
    """A call that needs no gradient (grad mode off, or no input requiring
    grad) calls every wrapper directly, no Function.apply; with gradients
    every pipeline calls each wrapper exactly as often, and every
    Function's apply runs."""
    applied = {}
    for fn in FUNCTIONS:
        def apply(*a, _orig=fn.apply, _name=fn.__name__):
            applied[_name] = applied.get(_name, 0) + 1
            return _orig(*a)
        monkeypatch.setattr(fn, "apply", apply)
    calls = _count_wrappers(monkeypatch)
    rng = np.random.default_rng(60)
    lat = np.linspace(-70, 70, 16)
    lon = np.linspace(0, 345, 24)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    q = np.sin(np.deg2rad(lat))[None, :, None] + 0.2 * rng.standard_normal(
        (2, 16, 24))
    q[0, 3:5, 4:7] = np.nan
    seen = []
    for mode in ("no_grad", "plain", "grad"):
        calls.clear()
        t = torch.tensor(q, requires_grad=mode != "plain")
        if mode == "no_grad":
            with torch.no_grad():
                _every_path(t, tg)
        else:
            loss = _every_path(t, tg)
        if mode != "grad":
            assert applied == {}, mode
        seen.append(dict(calls))
    g, = torch.autograd.grad(loss, t)
    assert torch.isfinite(g).any()
    assert seen[0] == seen[1] == seen[2]
    assert set(applied) == {fn.__name__ for fn in FUNCTIONS}
    # six paths, each one step and one table build
    assert seen[2]["weighted_cdf"] == 2 * 6
    # fractal_pipeline's box counting: every stride in one call
    assert seen[2]["box_counts"] == 1
