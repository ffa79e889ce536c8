"""Gradients through the port's sorted state and LWA against ``jax.grad``
of the JAX package's XLA path: the contours, K2's Function, the table
lookup and interpolation, and LWA's Function ('lin' and 'dense', both
variants, every part), K1's Function.

The cases mirror tests/test_differentiable.py.  Same numpy inputs in
float64 on both sides; the non-finite pattern must be equal and the values
within rtol=1e-8, atol=1e-12 of the largest |gradient|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import core as jcore
from xcontour_tpu import grid as jgrid
from xcontour_tpu.diagnostics import lwa as jlwa
from xcontour_tpu.ops.histogram import weighted_cdf_multi as jcdf_multi
from xcontour_tpu.ops.stencil import squared_gradient as jsq
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.ops.histogram import weighted_cdf_multi as tcdf_multi

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


def _grids(lat, lon):
    return (jgrid.from_latlon(lat, lon, dtype=jnp.float64),
            xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU))


def _chain(mod, grid, N, batched):
    """tests/test_differentiable.py's _loss_chain: table, contours, CDF,
    lookup, Q, LWA ('auto': 'lin')."""
    np_ = jnp if mod is jcore else torch
    Ny, Nx = grid.dA.shape
    mask = np_.ones((Ny, Nx), dtype=grid.dA.dtype)
    lwa = jlwa.local_wave_activity if mod is jcore else xt.local_wave_activity

    def loss(t):
        t3 = t if batched else t[None]
        table = mod.cal_area_eqCoord_table_hist(mask, grid.ydef, grid.dA,
                                                increase=True, lt=True)
        ctr = mod.cal_contours(t3, N, increase=True)
        ia = mod.cal_integral_within_contours_hist(t3, ctr, grid.dA, lt=True)
        Q = mod.interp_to_coords(grid.ydef, table.lookup_coordinates(ia), ctr)
        out = lwa(t3, Q, grid.dA, grid.ydef, increase=True)
        if batched:
            return np_.nansum(np_.abs(out))
        return np_.nansum(out * out)
    return loss


@pytest.mark.parametrize("batched", [False, True])
def test_sorted_state_and_lwa_chain_matches_jax(batched):
    """The chain of test_lwa_adjoint_matches_finite_differences (one
    snapshot, N = 21) and of test_adjoint_through_batched_pipeline_is_finite
    (three snapshots, N = 11)."""
    rng = np.random.default_rng(10 + batched)
    Ny, Nx = (16, 32) if batched else (24, 48)
    lat = np.linspace(-70, 70, Ny) if batched else np.linspace(-75, 75, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    jg, tg = _grids(lat, lon)
    if batched:
        v = np.sin(np.deg2rad(lat))[:, None] + 0.05 * rng.standard_normal(
            (3, Ny, Nx))
    else:
        v = (np.sin(np.deg2rad(lat))[:, None] + 0.15 * np.cos(
            3 * np.deg2rad(lon))[None, :] * np.cos(np.deg2rad(lat))[:, None]
            + 0.02 * rng.standard_normal((Ny, Nx)))
    N = 11 if batched else 21
    want = jax.grad(_chain(jcore, jg, N, batched))(jnp.asarray(v))
    assert_grad_equal(torch_grad(_chain(xt, tg, N, batched), v), want)


@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("part", ["upper", "lower"])
def test_part_selection_gradients_match_jax(part, variant2):
    """part='upper'/'lower' ('dense', K4's Function) with a NaN cell."""
    rng = np.random.default_rng(20 + 2 * variant2 + (part == "lower"))
    Ny, Nx = 12, 16
    ydef = np.linspace(-60.0, 60.0, Ny)
    q = np.cumsum(rng.normal(size=(2, Ny, Nx)), axis=1)
    q[0, 3, 4] = np.nan
    dA = rng.uniform(0.5, 2.0, size=(Ny, Nx))
    Q = np.sort(rng.normal(size=(2, Ny)), axis=-1)
    jfn = jlwa.local_wave_activity2 if variant2 else jlwa.local_wave_activity
    tfn = xt.local_wave_activity2 if variant2 else xt.local_wave_activity

    def jloss(t):
        out = jfn(t, jnp.asarray(Q), jnp.asarray(dA), jnp.asarray(ydef),
                  increase=True, part=part, method="dense")
        return jnp.nansum(out * out)

    def tloss(t):
        out = tfn(t, torch.tensor(Q), torch.tensor(dA), torch.tensor(ydef),
                  increase=True, part=part, method="dense")
        return torch.nansum(out * out)

    want = jax.grad(jloss)(jnp.asarray(q))
    assert np.isfinite(np.asarray(want)).all()
    assert_grad_equal(torch_grad(tloss, q), want)


def _flags(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        increase = bool(rng.integers(2))
        coord_down = bool(rng.integers(2))
        variant2 = bool(rng.integers(2))
        part = ["all", "upper", "lower"][rng.integers(3)]
        method = "dense" if part != "all" else ["dense", "lin"][rng.integers(2)]
        out.append((increase, coord_down, variant2, part, method))
    return out


FLAGS = _flags(12, 7)


@pytest.mark.parametrize("trial", range(len(FLAGS)))
def test_lwa_flag_matrix_gradients_match_jax(trial):
    """test_grad_flag_matrix_fuzz's 12 trials: tracer direction, coordinate
    direction, variant, part and method; the gradients of q and Q."""
    increase, coord_down, variant2, part, method = FLAGS[trial]
    rng = np.random.default_rng(100 + trial)
    Ny, Nx = 10, 12
    ydef = np.linspace(-60.0, 60.0, Ny)
    if coord_down:
        ydef = ydef[::-1].copy()
    base = np.cumsum(rng.normal(size=(Ny, Nx)), axis=0)
    Q = np.sort(rng.normal(size=(Ny,)))
    if not increase:
        base, Q = -base, Q[::-1].copy()
    dA = rng.uniform(0.5, 2.0, size=(Ny, Nx))
    kw = dict(increase=increase, part=part, method=method)
    jfn = jlwa.local_wave_activity2 if variant2 else jlwa.local_wave_activity
    tfn = xt.local_wave_activity2 if variant2 else xt.local_wave_activity

    def jloss(t, P):
        out = jfn(t, P, jnp.asarray(dA), jnp.asarray(ydef), **kw)
        return jnp.nansum(out * out)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(base), jnp.asarray(Q))
    t = torch.tensor(base, requires_grad=True)
    P = torch.tensor(Q, requires_grad=True)
    out = tfn(t, P, torch.tensor(dA), torch.tensor(ydef), **kw)
    got = torch.autograd.grad(torch.nansum(out * out), (t, P))
    nonzero = bool(np.abs(np.asarray(want[0])).max() > 0)
    for g, w in zip(got, want):
        assert_grad_equal(g, w, nonzero=nonzero)


@pytest.mark.parametrize("bc_y,periodic", [("extend", True), ("reflect", True),
                                           ("fill", False)])
def test_squared_gradient_gradients_match_jax(bc_y, periodic):
    """K1's Function: |grad q|^2 on a lat-lon grid (periodic x) and a
    Cartesian one, each y-wall condition, with a NaN cell."""
    rng = np.random.default_rng(30)
    Ny, Nx = 12, 20
    q = np.cumsum(rng.normal(size=(2, Ny, Nx)), axis=-1)
    q[1, 5, 7] = np.nan
    r = rng.normal(size=q.shape)
    if periodic:
        lat = np.linspace(-80, 80, Ny)
        lon = np.linspace(0, 360 - 360 / Nx, Nx)
        jg, tg = _grids(lat, lon)
    else:
        y, x = np.linspace(0, 1e5, Ny), np.linspace(0, 3e5, Nx)
        jg = jgrid.from_cartesian(y, x, dtype=jnp.float64)
        tg = xt.from_cartesian(y, x, dtype=torch.float64, device=CPU)
    want = jax.grad(lambda t: jnp.nansum(jsq(t, jg, bc_y=bc_y) * r))(
        jnp.asarray(q))
    got = torch_grad(lambda t: torch.nansum(
        xt.squared_gradient(t, tg, bc_y=bc_y) * torch.tensor(r)), q)
    assert_grad_equal(got, want)


@pytest.mark.parametrize("lt", [True, False])
@pytest.mark.parametrize("decreasing", [False, True])
def test_weighted_cdf_weight_gradients_match_jax(lt, decreasing):
    """K2's Function: three channels over one digitize, values on edges,
    below the first and on the top edge, NaN values and NaN weights, bins
    either way; the cotangent of each weight and of the values (zero)."""
    rng = np.random.default_rng(40 + 2 * lt + decreasing)
    B, Ny, Nx, N = 2, 9, 11, 7
    v = rng.normal(size=(B, Ny, Nx))
    bins = np.sort(rng.normal(size=(B, N)), axis=-1)
    if decreasing:
        bins = bins[:, ::-1].copy()
    v[0, 0, :3] = bins[0, 2]
    v[1, 1, :2] = bins[1].max()
    v[1, 2, :2] = bins[1].min() - 5.0
    v[0, 4, 5] = np.nan
    ws = [rng.uniform(0.5, 1.5, size=(B, Ny, Nx)) for _ in range(3)]
    ws[1][1, 3, 3] = np.nan
    r = rng.normal(size=(3, B, N))

    def jloss(vv, *w):
        outs = jcdf_multi(vv, jnp.asarray(bins), list(w), lt)
        return sum(jnp.sum(o * rr) for o, rr in zip(outs, r))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(v), *(jnp.asarray(w) for w in ws))
    tv = torch.tensor(v, requires_grad=True)
    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    outs = tcdf_multi(tv, torch.tensor(bins), tw, lt)
    loss = sum(torch.sum(o * torch.tensor(rr)) for o, rr in zip(outs, r))
    got = torch.autograd.grad(loss, [tv, *tw], allow_unused=True)
    assert got[0] is None and not np.asarray(want[0]).any()
    for g, w in zip(got[1:], want[1:]):
        assert_grad_equal(g, w)


@pytest.mark.parametrize("nan_weight", [False, True])
@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("increase", [True, False])
def test_fast_gradients_match_jax(increase, variant2, nan_weight):
    """'fast' (no Function: autograd through sort, gather and cumsum, as
    jax.grad goes through lax.sort): the gradients of q, Q and the weight,
    with a NaN cell, and with a NaN weight (whose 0 * NaN cotangent reaches
    the profile's mean, so that every gradient of Q may be NaN: in both
    packages alike)."""
    rng = np.random.default_rng(50 + 2 * variant2 + increase)
    Ny, Nx = 14, 10
    ydef = np.linspace(-60.0, 60.0, Ny)
    q = np.cumsum(rng.normal(size=(2, Ny, Nx)), axis=1)
    Q = np.sort(rng.normal(size=(2, Ny)) * 2.0, axis=-1)
    if not increase:
        q, Q = -q, Q[:, ::-1].copy()
    q[0, 3, 4] = np.nan
    W = rng.uniform(0.5, 2.0, size=(Ny, Nx))
    if nan_weight:
        W[7, 2] = np.nan
    dA = np.ones((Ny, Nx))
    jfn = jlwa.local_wave_activity2 if variant2 else jlwa.local_wave_activity
    tfn = xt.local_wave_activity2 if variant2 else xt.local_wave_activity

    def jloss(t, P, w):
        out = jfn(t, P, jnp.asarray(dA), jnp.asarray(ydef), increase=increase,
                  weight=w, method="fast")
        return jnp.nansum(out * out)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W))
    args = [torch.tensor(a, requires_grad=True) for a in (q, Q, W)]
    out = tfn(args[0], args[1], torch.tensor(dA), torch.tensor(ydef),
              increase=increase, weight=args[2], method="fast")
    got = torch.autograd.grad(torch.nansum(out * out), args)
    for g, w in zip(got, want):
        assert_grad_equal(g, w, nonzero=np.isfinite(np.asarray(w)).any())
    if not nan_weight:
        assert np.isfinite(np.asarray(want[1])).all()


@pytest.mark.parametrize("lt", [True, False])
def test_exact_integral_gradients_match_jax(lt):
    """The exact conditional integral's gradient with respect to its
    weights (dA and the integrand), NaN values and a NaN weight included;
    the values get none (JAX: zeros)."""
    rng = np.random.default_rng(60 + lt)
    B, Ny, Nx, N = 2, 9, 11, 7
    v = rng.normal(size=(B, Ny, Nx)).cumsum(1)
    v[0, 2, 3] = np.nan
    dA = rng.uniform(0.5, 1.5, size=(Ny, Nx))
    dA[4, 4] = np.nan
    f = rng.normal(size=(B, Ny, Nx))
    ctr = np.stack([np.linspace(np.nanmin(v[b]), np.nanmax(v[b]), N)
                    for b in range(B)])
    r = rng.normal(size=(B, N))

    def jloss(vv, a, ff):
        out = jcore.cal_integral_within_contours_exact(
            vv, jnp.asarray(ctr), a, ff, lt=lt)
        return jnp.sum(out * r)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(v), jnp.asarray(dA), jnp.asarray(f))
    args = [torch.tensor(a, requires_grad=True) for a in (v, dA, f)]
    out = xt.cal_integral_within_contours_exact(
        args[0], torch.tensor(ctr), args[1], args[2], lt=lt)
    got = torch.autograd.grad(torch.sum(out * torch.tensor(r)), args,
                              allow_unused=True)
    assert got[0] is None and not np.asarray(want[0]).any()
    for g, w in zip(got[1:], want[1:]):
        assert_grad_equal(g, w)
