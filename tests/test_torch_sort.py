"""The exact sort-based conditional integrals and ``cal_contours_at``: the
port's ``ops.sort.exact_conditional_integral``,
``core.cal_integral_within_contours_exact`` and ``core.cal_contours_at``
against the JAX package's on the same numpy inputs, and against the
float64 broadcast oracle.

Tolerances: float64 throughout.  The exact path sums the sorted weights in
another order than the broadcast path and JAX's, so sums agree to 1e-11 of
the largest; where the data admit no rounding (integer weights) they are
equal bit for bit.  ``cal_contours_at`` compares levels to 1e-10 of the
largest (the table lookup and interpolation amplify the sums' noise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import compat
from xcontour_tpu import core as jcore
from xcontour_tpu import grid as jgrid
from xcontour_tpu.ops.sort import exact_conditional_integral as jexact
from xcontour_tpu.utils.synth import synth_pv
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.ops.sort import exact_conditional_integral

CPU = "cpu"
RTOL = 1e-11


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    scale = max(np.abs(want[m]).max(), 1e-300) if m.any() else 1.0
    np.testing.assert_allclose(got[m], want[m], rtol=0, atol=rtol * scale)


def _field(seed, B=3, Ny=20, Nx=30):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(B, Ny, Nx)).cumsum(1)
    v[0, 4:8, 10:15] = np.nan
    dA = rng.uniform(0.5, 2.0, size=(Ny, Nx))
    return rng, v, dA


CASES = ["plain", "nan_weights", "integrand", "decreasing", "shared_levels"]


@pytest.mark.parametrize("lt", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_exact_matches_jax_and_broadcast_oracle(case, lt):
    rng, v, dA = _field(1 + CASES.index(case))
    f = rng.uniform(-1.0, 1.0, size=v.shape) if case == "integrand" else None
    if case == "nan_weights":
        dA[2, 3] = np.nan
    ctr = np.stack([compat.contours_linspace(v[b], 17, case != "decreasing")
                    for b in range(v.shape[0])])
    if case == "shared_levels":
        ctr = np.linspace(np.nanmin(v), np.nanmax(v), 13)
    jf = None if f is None else jnp.asarray(f)
    want = jcore.cal_integral_within_contours_exact(
        jnp.asarray(v), jnp.asarray(ctr), jnp.asarray(dA), jf, lt=lt)
    got = xt.cal_integral_within_contours_exact(
        torch.as_tensor(v), torch.as_tensor(ctr), torch.as_tensor(dA),
        None if f is None else torch.as_tensor(f), lt=lt)
    _close(got, want)
    levels = np.broadcast_to(ctr, v.shape[:1] + ctr.shape[-1:])
    oracle = np.stack([compat.integral_within_contours(
        v[b], levels[b], dA, None if f is None else f[b], lt)
        for b in range(v.shape[0])])
    _close(got, oracle)


def test_exact_unbatched_field_with_one_dimensional_levels():
    _, v, dA = _field(8)
    ctr = compat.contours_linspace(v[1], 11, True)
    for lt in (True, False):
        want = jexact(jnp.asarray(v[1]), jnp.asarray(ctr), jnp.asarray(dA), lt)
        got = exact_conditional_integral(torch.as_tensor(v[1]),
                                         torch.as_tensor(ctr),
                                         torch.as_tensor(dA), lt)
        assert got.shape == (11,)
        _close(got, want)


def test_exact_all_nan_element_gives_zeros():
    """An all-NaN batch element: NaN levels from cal_contours and finite
    levels alike give exact zeros, as in JAX."""
    _, v, dA = _field(9)
    v[2] = np.nan
    for lt in (True, False):
        for ctr in (np.array(jcore.cal_contours(jnp.asarray(v), 9)),
                    np.linspace(-3.0, 3.0, 9)):
            want = np.asarray(jcore.cal_integral_within_contours_exact(
                jnp.asarray(v), jnp.asarray(ctr), jnp.asarray(dA), lt=lt))
            got = xt.cal_integral_within_contours_exact(
                torch.as_tensor(v), torch.as_tensor(ctr), torch.as_tensor(dA),
                lt=lt).numpy()
            assert (got[2] == 0).all() and (want[2] == 0).all()
            _close(got, want)


def test_exact_nan_level_gives_the_total_for_lt_and_zero_for_gt():
    """A NaN level in an element with finite values searches to the end of
    the sorted row: the element's total for lt, 0 for gt, as the JAX path
    gives (the broadcast path gives 0 for both).  Kept as JAX has it."""
    _, v, dA = _field(10)
    ctr = np.stack([compat.contours_linspace(v[b], 7, True) for b in range(3)])
    ctr[1, 3] = np.nan
    total = np.nansum(np.where(np.isnan(v[1]), np.nan, dA))
    for lt in (True, False):
        want = np.asarray(jcore.cal_integral_within_contours_exact(
            jnp.asarray(v), jnp.asarray(ctr), jnp.asarray(dA), lt=lt))
        got = xt.cal_integral_within_contours_exact(
            torch.as_tensor(v), torch.as_tensor(ctr), torch.as_tensor(dA),
            lt=lt).numpy()
        _close(got, want)
        if lt:
            np.testing.assert_allclose(got[1, 3], total, rtol=1e-12)
        else:
            assert got[1, 3] == 0.0
        bcast = xt.cal_integral_within_contours(
            torch.as_tensor(v), torch.as_tensor(ctr), torch.as_tensor(dA),
            lt=lt).numpy()
        assert bcast[1, 3] == 0.0


def test_exact_ties_are_strict_bit_for_bit():
    """Integer values on integer levels with unit weights: every tie is
    left out on both sides (strict comparisons), and the sums are exact."""
    rng = np.random.default_rng(11)
    v = rng.integers(0, 6, size=(2, 12, 17)).astype(np.float64)
    w = np.ones((12, 17))
    ctr = np.arange(-1.0, 8.0)
    for lt in (True, False):
        got = xt.cal_integral_within_contours_exact(
            torch.as_tensor(v), torch.as_tensor(ctr), torch.as_tensor(w),
            lt=lt).numpy()
        want = np.stack([[(v[b] < c).sum() if lt else (v[b] > c).sum()
                          for c in ctr] for b in range(2)]).astype(np.float64)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(
            jcore.cal_integral_within_contours_exact(
                jnp.asarray(v), jnp.asarray(ctr), jnp.asarray(w), lt=lt)))


def _contours_at_inputs(increase, nlat=48, nlon=72):
    v, _ = synth_pv(nlev=3, nlat=nlat, nlon=nlon, seed=21)
    lat = v["latitude"].astype(np.float64)
    lon = v["longitude"].astype(np.float64)
    q = v["pv"].astype(np.float64)
    q[0, 5:9, 10:20] = np.nan
    if not increase:
        q = -q
    return lat, lon, q


@pytest.mark.parametrize("method", ["exact", "broadcast", "hist"])
@pytest.mark.parametrize("increase,lt", [(True, True), (True, False),
                                         (False, False)])
def test_cal_contours_at_matches_jax(method, increase, lt):
    lat, lon, q = _contours_at_inputs(increase)
    jg = jgrid.from_latlon(lat, lon, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    predef = np.linspace(-80.0, 80.0, 21)
    jt = jcore.cal_area_eqCoord_table_hist(
        jg.fluid_mask(jnp.float64), jg.ydef, jg.dA, increase=increase, lt=lt)
    tt = xt.cal_area_eqCoord_table_hist(
        tg.fluid_mask(torch.float64), tg.ydef, tg.dA, increase=increase,
        lt=lt)
    want = jcore.cal_contours_at(jnp.asarray(predef), jt, jnp.asarray(q),
                                 jg.dA, increase=increase, lt=lt,
                                 method=method)
    got = xt.cal_contours_at(torch.as_tensor(predef), tt, torch.as_tensor(q),
                             tg.dA, increase=increase, lt=lt, method=method)
    assert got.shape == (3, 21)
    _close(got, want, 1e-10)


def test_cal_contours_at_exact_round_trips_and_hist_under_counts():
    """The exact levels at interior coordinates enclose the table's area
    there; the 'hist' path keeps the reference's window, so its levels
    differ from the exact ones at interior coordinates; an unknown method
    raises."""
    lat, lon, q = _contours_at_inputs(True)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    table = xt.cal_area_eqCoord_table_hist(
        tg.fluid_mask(torch.float64), tg.ydef, tg.dA, increase=True, lt=True)
    predef = torch.linspace(-60.0, 60.0, 13, dtype=torch.float64)
    tq = torch.as_tensor(q)
    kw = dict(increase=True, lt=True)
    exact = xt.cal_contours_at(predef, table, tq, tg.dA, **kw)
    area = xt.cal_integral_within_contours_exact(tq, exact, tg.dA, lt=True)
    back = table.lookup_coordinates(area)
    # a level between grid values encloses the area of the cells below it;
    # the residue is at most about a grid row of latitude
    assert (back - predef).abs().max() < 2 * float(lat[1] - lat[0])
    hist = xt.cal_contours_at(predef, table, tq, tg.dA, method="hist", **kw)
    assert not torch.allclose(hist, exact)
    with pytest.raises(ValueError, match="method"):
        xt.cal_contours_at(predef, table, tq, tg.dA, method="sort", **kw)
