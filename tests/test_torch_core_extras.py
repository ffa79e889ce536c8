"""The lookup options and helpers the earlier slices left out, against the
JAX package on the same numpy inputs: ``interp1d`` with per-row directions,
``extrapolate='nan'`` and both sides of its size split; ``interp_to_coords``
with ``increasing`` and ``axis``; ``Table.check_direction``;
``get_extrema_extend``; ``Grid.total_area``, ``Grid.integrate`` and
``to_host``; and ``contour_crossing``'s statistic, ramp and empty pad modes.

Tolerances: float64.  Interpolation agrees with np.interp and JAX to
1e-12; sums (areas, integrals, pad means) to 1e-13 relative; box counting
to 1e-12, as tests/test_torch_length.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import core as jcore
from xcontour_tpu import grid as jgrid
from xcontour_tpu.diagnostics import length as jlength
from xcontour_tpu.ops import interp as jinterp
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.diagnostics import length as tlength
from xcontour_tpu_torch.ops import interp as tinterp

CPU = "cpu"


def _np_ref(x, xf, yf):
    out = []
    for b in range(x.shape[0]):
        up = xf[b, -1] > xf[b, 0]
        xs, ys = (xf[b], yf[b]) if up else (xf[b, ::-1], yf[b, ::-1])
        out.append(np.interp(x[b], xs, ys))
    return np.stack(out)


@pytest.fixture(params=["dense", "search"])
def form(request, monkeypatch):
    """Each case through both forms: 'search' lowers the dense limit to 0
    so every table is searched row by row."""
    if request.param == "search":
        monkeypatch.setattr(tinterp, "_DENSE_N_MAX", 0)
    return request.param


def _mixed_rows(rng, B=6, M=41, N=23):
    xf = np.sort(rng.standard_normal((B, N)), -1)
    xf[1::2] = xf[1::2, ::-1]                    # every other row decreasing
    yf = rng.standard_normal((B, N))
    x = rng.standard_normal((B, M)) * 1.5
    return x, xf, yf


def test_interp1d_per_row_direction_matches_jax_and_numpy(form):
    x, xf, yf = _mixed_rows(np.random.default_rng(1))
    got = tinterp.interp1d(*(torch.as_tensor(a) for a in (x, xf, yf))).numpy()
    want = np.asarray(jinterp.interp1d(*(jnp.asarray(a) for a in (x, xf, yf))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, _np_ref(x, xf, yf), rtol=1e-12,
                               atol=1e-12)


def test_interp1d_nan_extrapolation_matches_jax(form):
    x, xf, yf = _mixed_rows(np.random.default_rng(2))
    x[:, :3] = [-10.0, 10.0, np.nan]
    got = tinterp.interp1d(*(torch.as_tensor(a) for a in (x, xf, yf)),
                           extrapolate="nan").numpy()
    want = np.asarray(jinterp.interp1d(*(jnp.asarray(a) for a in (x, xf, yf)),
                                       extrapolate="nan"))
    assert np.isnan(got[:, :3]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="extrapolate"):
        tinterp.interp1d(torch.as_tensor(x), torch.as_tensor(xf),
                         torch.as_tensor(yf), extrapolate="linear")


def test_interp1d_edges_follow_np_interp(form):
    """Exact hits, a duplicated abscissa (the right endpoint's value),
    clamping and NaN queries, with one direction given for all rows."""
    xf = np.array([[0.0, 1.0, 1.0, 2.0, 3.0, 3.0]])
    yf = np.array([[0.0, 10.0, 20.0, 30.0, 40.0, 50.0]])
    x = np.array([[-1.0, 0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, np.nan]])
    got = tinterp.interp1d(*(torch.as_tensor(a) for a in (x, xf, yf)),
                           increasing=True).numpy()
    want = np.interp(x[0], xf[0], yf[0])
    np.testing.assert_array_equal(got[0], want)


def test_interp1d_large_table_searches_rows():
    """Past _DENSE_N_MAX (and past _DENSE_ELEMS_MAX compare elements) the
    rows are searched: the JAX package's split, np.interp's results."""
    rng = np.random.default_rng(3)
    N = tinterp._DENSE_N_MAX + 8
    assert N > jinterp._DENSE_N_MAX
    xf = np.sort(rng.standard_normal((2, N)), -1)
    xf[1] = xf[1, ::-1]
    yf = rng.standard_normal((2, N))
    x = rng.standard_normal((2, 64))
    got = tinterp.interp1d(*(torch.as_tensor(a) for a in (x, xf, yf))).numpy()
    want = np.asarray(jinterp.interp1d(*(jnp.asarray(a) for a in (x, xf, yf))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, _np_ref(x, xf, yf), rtol=1e-12,
                               atol=1e-12)
    N = 2048
    M = tinterp._DENSE_ELEMS_MAX // N + 17
    xf = np.sort(rng.standard_normal((1, N)), -1)
    yf = rng.standard_normal((1, N))
    x = rng.standard_normal((1, M))
    got = tinterp.interp1d(*(torch.as_tensor(a) for a in (x, xf, yf))).numpy()
    np.testing.assert_allclose(got, _np_ref(x, xf, yf), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("case", ["last", "first_equal_ranks",
                                  "negative_unequal_ranks", "increasing"])
def test_interp_to_coords_axis_matches_jax(case):
    rng = np.random.default_rng(4)
    predef = np.linspace(-50.0, 50.0, 9)
    eq = np.sort(rng.uniform(-80, 80, (3, 4, 11)), -1)
    var = rng.standard_normal((3, 4, 11))
    kw = {}
    if case == "first_equal_ranks":
        eq, var, kw = np.moveaxis(eq, -1, 0), np.moveaxis(var, -1, 0), \
            dict(axis=0)
    elif case == "negative_unequal_ranks":
        eq = np.moveaxis(eq[0], -1, 0)                       # (11, 4)
        var = np.moveaxis(var, -1, 1)                        # (3, 11, 4)
        kw = dict(axis=-2)
    elif case == "increasing":
        kw = dict(increasing=False)
        eq = eq[..., ::-1].copy()
    want = np.asarray(jcore.interp_to_coords(
        jnp.asarray(predef), jnp.asarray(eq), jnp.asarray(var), **kw))
    got = xt.interp_to_coords(torch.as_tensor(predef), torch.as_tensor(eq),
                              torch.as_tensor(var), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_interp_to_coords_nonnegative_axis_needs_equal_ranks():
    with pytest.raises(ValueError, match="negative axis"):
        xt.interp_to_coords(torch.zeros(3), torch.zeros(5, 4),
                            torch.zeros(2, 5, 4), axis=0)


def test_table_check_direction():
    coords = torch.tensor([-1.0, 0.0, 1.0])
    good = xt.Table(values=torch.tensor([[0.0, 1.0, 2.0], [1.0, 2.0, 4.0]]),
                    coords=coords)
    assert good.check_direction() is None
    bad = xt.Table(values=torch.tensor([[0.0, 1.0, 2.0], [2.0, 1.0, 0.0]]),
                   coords=coords)
    with pytest.raises(ValueError, match="mixed-direction"):
        bad.check_direction()


@pytest.mark.parametrize("nan", ["some", "all"])
def test_get_extrema_extend_matches_jax(nan):
    rng = np.random.default_rng(5)
    d = rng.standard_normal((2, 7, 9))
    if nan == "some":
        d[0, :3] = np.nan
    else:
        d[:] = np.nan
    with np.errstate(invalid="ignore"):
        want = [np.asarray(w) for w in jcore.get_extrema_extend(
            jnp.asarray(d), 40)]
    got = [g.numpy() for g in xt.get_extrema_extend(torch.as_tensor(d), 40)]
    np.testing.assert_allclose(got, want, rtol=1e-15)
    assert np.isnan(got).all() == (nan == "all")


def test_grid_total_area_integrate_and_to_host_match_jax():
    rng = np.random.default_rng(6)
    lat = np.linspace(-80, 80, 17)
    lon = np.linspace(0, 350, 36)
    mask = (rng.uniform(size=(17, 36)) > 0.2).astype(np.float64)
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, mask=mask, dtype=torch.float64, device=CPU)
    np.testing.assert_allclose(tg.total_area().item(),
                               float(jg.total_area()), rtol=1e-13)
    f = rng.standard_normal((3, 17, 36))
    f[1, 2, 3] = np.nan
    np.testing.assert_allclose(tg.integrate(torch.as_tensor(f)).numpy(),
                               np.asarray(jg.integrate(jnp.asarray(f))),
                               rtol=1e-13)
    host = xt.to_host(tg)
    assert host.dA.device.type == "cpu" and host.mask.device.type == "cpu"
    assert (host.latlon, host.periodic_x, host.dim_names) == \
        (tg.latlon, tg.periodic_x, tg.dim_names)
    jh = jgrid.to_host(jg)
    for name in ("ydef", "xdef", "dA", "dxF", "dyF", "mask"):
        np.testing.assert_array_equal(getattr(host, name).numpy(),
                                      getattr(jh, name))


NEW_MODES = ["mean", "maximum", "minimum", "median", "linear_ramp"]


@pytest.mark.parametrize("mode", NEW_MODES + ["empty"])
@pytest.mark.parametrize("n,pad", [(5, 3), (4, 9), (1, 2)])
def test_new_pad_modes_match_numpy_and_jax(mode, n, pad):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((3, n))
    a[2, 0] = np.nan
    got = tlength._pad_x(torch.as_tensor(a), pad, mode).numpy()
    want = np.asarray(jnp.pad(jnp.asarray(a), [(0, 0), (0, pad)], mode=mode))
    if mode == "empty":
        # np.pad leaves 'empty' columns undefined: the port writes zeros
        np.testing.assert_array_equal(got[:, :n], a)
        assert (got[:, n:] == 0).all()
        return
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(got, np.pad(a, [(0, 0), (0, pad)], mode=mode),
                               rtol=1e-15, atol=0)


@pytest.mark.parametrize("mode", NEW_MODES + ["empty"])
@pytest.mark.parametrize("stride", [2, [1, 3]])
def test_crossing_new_pad_modes_match_jax(mode, stride):
    rng = np.random.default_rng(8)
    d = rng.standard_normal((2, 23, 37)).cumsum(1)
    d[1, 5:8, 30:37] = np.nan                    # NaN cells at the x seam
    area = rng.uniform(1.0, 4.0, (23, 37))
    ctr = np.stack([np.linspace(np.nanmin(d[b]), np.nanmax(d[b]), 7)
                    for b in range(2)])
    want = jlength.contour_crossing(jnp.asarray(d), jnp.asarray(ctr),
                                    jnp.asarray(area), stride, mode=mode)
    got = xt.contour_crossing(torch.as_tensor(d), torch.as_tensor(ctr),
                              torch.as_tensor(area), stride, mode=mode)
    if not isinstance(stride, list):
        want, got = [want], [got]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
