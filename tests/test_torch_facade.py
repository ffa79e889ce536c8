"""The port's ``Contour2D`` facade, ``lwa_masks_at`` and ``utils.checks``
against the JAX package's on the same seeded numpy inputs.

Every method runs in both constructor generations: the grid-first one
(``Contour2D(grid, tracer)`` on ``add_latlon_metrics``' grid) and the
vendored one (``Contour2D.from_arrays(tracer, dA, ydef, xdef)``).  The
tracer is ``synth_pv`` in float64 with a NaN patch.

Tolerances: float64 throughout.  The facade adds no arithmetic of its own,
so where both packages run the same operations in the same order (levels,
tables, the broadcast and histogram integrals, the Keff algebra, the
masks) the outputs are held at 1e-12 of the largest magnitude, and the
masks and contour values of ``mask_idx`` bit for bit.  The exact integral
and LWA sum in another order than JAX's: 1e-11 of the largest, the bound
of tests/test_torch_sort.py and tests/test_torch_lwa.py.  The NaN pattern
is always equal.

Where each package computes its own levels from the tracer, their count
is even.  ``synth_pv`` is antisymmetric about the equator, whose row is 0,
so an odd count puts a level at the midpoint of the range: 0 in the port
and 6.8e-21 in the JAX package (XLA rounds steps * k + start once, as a
fused multiply-add), on either side of the row's zeros, and the area and
length enclosed jump.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import xcontour as JX
from xcontour_tpu.diagnostics import lwa as jlwa
from xcontour_tpu.utils import checks as jchecks
from xcontour_tpu.utils.synth import synth_pv
from xcontour_tpu_torch import xcontour as TX
from xcontour_tpu_torch.diagnostics import lwa as tlwa
from xcontour_tpu_torch.utils import checks as tchecks

CPU = "cpu"
SAME = 1e-12      # the same operations in the same order
ORDER = 1e-11     # another summation order
GENERATIONS = ["grid", "arrays"]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=SAME):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    np.testing.assert_array_equal(m, np.isfinite(got))
    if m.any():
        scale = max(np.abs(want[m]).max(), 1e-300)
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=rtol * scale)


def _field(seed=3, B=2, Ny=25, Nx=48):
    v, _ = synth_pv(nlev=B, nlat=Ny, nlon=Nx, seed=seed)
    pv = v["pv"].astype(np.float64)
    pv[0, 14:17, 5:11] = np.nan
    return (v["latitude"].astype(np.float64),
            v["longitude"].astype(np.float64), pv)


def _pair(gen, increase=True, lt=False, check_mono=False, seed=3):
    """(JAX facade, port facade, tracer) of one constructor generation."""
    lat, lon, pv = _field(seed)
    kw = dict(increase=increase, lt=lt, check_mono=check_mono)
    dset = {"latitude": lat, "longitude": lon}
    _, jg = JX.add_latlon_metrics(dset, dtype=jnp.float64)
    _, tg = TX.add_latlon_metrics(dset, dtype=torch.float64, device=CPU)
    if gen == "grid":
        return (JX.Contour2D(jg, pv, dtype=jnp.float64, **kw),
                TX.Contour2D(tg, pv, dtype=torch.float64, **kw), pv)
    dA = np.asarray(jg.dA)
    return (JX.Contour2D.from_arrays(pv, dA, lat, lon, latlon=True,
                                     periodic_x=True, dtype=jnp.float64, **kw),
            TX.Contour2D.from_arrays(pv, dA, lat, lon, latlon=True,
                                     periodic_x=True, dtype=torch.float64,
                                     device=CPU, **kw), pv)


@pytest.fixture(params=GENERATIONS)
def pair(request):
    return _pair(request.param)


def test_ctor_validation_branches(pair):
    _, an, pv = pair
    grid = an.grid
    with pytest.raises(ValueError, match="one dimension"):
        TX.Contour2D(grid, pv, dimEq={"Y": "lat", "Z": "lev"})
    with pytest.raises(ValueError, match="2D plane"):
        TX.Contour2D(grid, pv, dims={"X": "lon"})
    with pytest.raises(ValueError, match="do not match grid dims"):
        TX.Contour2D(grid, pv, dims={"X": "bogus", "Y": "weird"})
    with pytest.raises(ValueError, match="arakawa"):
        TX.Contour2D(grid, pv, arakawa="B")
    ok = TX.Contour2D(grid, pv, dims={"X": grid.dim_names[1],
                                      "Y": grid.dim_names[0]},
                      dimEq={"Y": grid.dim_names[0]}, arakawa="C")
    assert ok.tracer.dtype == torch.float32 and ok.arakawa == "C"


def test_tensor_on_another_device_raises_and_names_both(pair):
    """A numpy tracer goes to the grid's device; a tensor elsewhere is not
    copied silently."""
    _, an, pv = pair
    elsewhere = torch.empty(pv.shape, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="meta.*cpu"):
        TX.Contour2D(an.grid, elsewhere, dtype=torch.float64)
    with pytest.raises(ValueError, match="meta.*cpu"):
        an.cal_local_wave_activity(elsewhere, elsewhere[..., 0])
    assert an.tracer.device == an.grid.dA.device


def test_from_arrays_defaults_to_the_card(monkeypatch):
    lat, lon, pv = _field()
    dA = np.ones(pv.shape[-2:])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TX.Contour2D.from_arrays(pv, dA, lat)
    an = TX.Contour2D.from_arrays(pv, torch.as_tensor(dA), torch.as_tensor(lat),
                                  device=CPU, dtype=torch.float64)
    ja = JX.Contour2D.from_arrays(pv, dA, lat, dtype=jnp.float64)
    np.testing.assert_array_equal(an.grid.xdef.numpy(), np.asarray(ja.grid.xdef))
    np.testing.assert_array_equal(an.dA.numpy(), np.asarray(ja.dA))


@pytest.mark.parametrize("levels", [21, "list", "array"])
def test_cal_contours(pair, levels):
    ja, an, _ = pair
    if levels == "list":
        levels = [-3e-5, 0.0, 1e-5, 4e-5]
    elif levels == "array":
        levels = np.linspace(-2e-4, 2e-4, 7)
    got, want = an.cal_contours(levels), ja.cal_contours(levels)
    assert got.dtype == torch.float64
    _close(got, want)


@pytest.mark.parametrize("increase,lt", [(True, False), (True, True),
                                         (False, False)])
@pytest.mark.parametrize("gen", GENERATIONS)
@pytest.mark.parametrize("kind", ["", "_hist"])
def test_tables(gen, increase, lt, kind):
    ja, an, _ = _pair(gen, increase=increase, lt=lt)
    mask = np.ones(an.grid.shape)
    mask[3, 4:9] = 0.0
    name = f"cal_area_eqCoord_table{kind}"
    got, want = getattr(an, name)(mask), getattr(ja, name)(mask)
    _close(got.values, want.values)
    _close(got.coords, want.coords)
    area = ja.cal_integral_within_contours(ja.cal_contours(15))
    _close(got.lookup_coordinates(torch.as_tensor(np.array(area))),
           want.lookup_coordinates(area))


@pytest.mark.parametrize("kind,rtol", [("", SAME), ("_hist", SAME),
                                       ("_exact", ORDER)])
@pytest.mark.parametrize("args", ["own", "tracer", "integrand"])
def test_integrals(pair, kind, rtol, args):
    ja, an, pv = pair
    ctr = ja.cal_contours(17)
    f = np.random.default_rng(5).uniform(0.5, 2.0, pv.shape)
    jkw, tkw = {}, {}
    if args == "tracer":
        jkw["tracer"] = jnp.asarray(pv * 1.5)
        tkw["tracer"] = torch.as_tensor(pv * 1.5)
    elif args == "integrand":
        jkw["integrand"], tkw["integrand"] = jnp.asarray(f), torch.as_tensor(f)
    name = f"cal_integral_within_contours{kind}"
    got = getattr(an, name)(torch.as_tensor(np.array(ctr)), **tkw)
    _close(got, getattr(ja, name)(ctr, **jkw), rtol)


@pytest.mark.parametrize("kind", ["", "_hist"])
def test_contour_means(pair, kind):
    ja, an, pv = pair
    rng = np.random.default_rng(11)
    f = rng.uniform(0.5, 2.0, pv.shape)
    grdm = np.abs(np.nan_to_num(pv)) + 0.1
    jctr = ja.cal_contours(13)
    tctr = torch.as_tensor(np.array(jctr))
    J, T = jnp.asarray, torch.as_tensor
    _close(getattr(an, f"cal_contour_weigh_mean{kind}")(tctr, T(f)),
           getattr(ja, f"cal_contour_weigh_mean{kind}")(jctr, J(f)))
    _close(getattr(an, f"cal_contour_mean{kind}")(tctr, T(f), T(grdm)),
           getattr(ja, f"cal_contour_mean{kind}")(jctr, J(f), J(grdm)))
    area = ja.cal_integral_within_contours(jctr)
    _close(getattr(an, f"cal_contour_weigh_mean{kind}")(
               tctr, T(f), T(np.asarray(area))),
           getattr(ja, f"cal_contour_weigh_mean{kind}")(jctr, J(f), area))


def test_keff_tail(pair):
    """cal_gradient_wrt_area, cal_sqared_equivalent_length and
    cal_normalized_Keff (its mask included) on the facade's own integrals."""
    ja, an, pv = pair
    jctr = ja.cal_contours(30)
    tctr = an.cal_contours(30)
    grdS = np.random.default_rng(2).uniform(1e-22, 1e-20, pv.shape)
    jA = ja.cal_integral_within_contours_hist(jctr)
    tA = an.cal_integral_within_contours_hist(tctr)
    jS = ja.cal_integral_within_contours_hist(jctr, integrand=jnp.asarray(grdS))
    tS = an.cal_integral_within_contours_hist(tctr,
                                              integrand=torch.as_tensor(grdS))
    jdq, tdq = ja.cal_gradient_wrt_area(jctr, jA), an.cal_gradient_wrt_area(tctr, tA)
    jdg, tdg = ja.cal_gradient_wrt_area(jS, jA), an.cal_gradient_wrt_area(tS, tA)
    _close(tdq, jdq)
    _close(tdg, jdg)
    jL, tL = ja.cal_sqared_equivalent_length(jdg, jdq), \
        an.cal_sqared_equivalent_length(tdg, tdq)
    _close(tL, jL)
    lmin = np.linspace(1e6, 4e7, 30)
    for mask in (1e5, 30.0):
        _close(an.cal_normalized_Keff(tL, torch.as_tensor(lmin), mask),
               ja.cal_normalized_Keff(jL, jnp.asarray(lmin), mask))


def _profile(pv):
    return np.sort(np.nanmean(pv, axis=-1), axis=-1)


@pytest.mark.parametrize("method", ["cal_local_wave_activity",
                                    "cal_local_wave_activity2",
                                    "cal_local_APE"])
@pytest.mark.parametrize("part,mask_idx", [("all", None), ("all", [2, 12, 23]),
                                           ("upper", [0, 24]),
                                           ("lower", None)])
@pytest.mark.parametrize("gen", GENERATIONS)
def test_lwa_methods(gen, method, part, mask_idx):
    """LWA, LWA2 and APE with and without ``mask_idx``: the field at 1e-11
    (another summation order), the contours and masks bit for bit, as
    lists of the same length."""
    ja, an, pv = _pair(gen, increase=method != "cal_local_APE")
    Q = _profile(pv)
    want = getattr(ja, method)(jnp.asarray(pv), jnp.asarray(Q), mask_idx,
                               part)
    got = getattr(an, method)(pv, Q, mask_idx, part)
    if mask_idx is None:
        _close(got, want, ORDER)
        return
    _close(got[0], want[0], ORDER)
    assert len(got[1]) == len(want[1]) == len(mask_idx)
    assert len(got[2]) == len(want[2]) == len(mask_idx)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("increase", [True, False])
@pytest.mark.parametrize("descending", [False, True])
def test_lwa_masks_at(variant2, increase, descending):
    """Both variants, both directions, an ascending and a descending
    coordinate, a NaN cell and a NaN profile value: bit for bit."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 3, 20, 16)).cumsum(2)
    q[0, 1, 4, 5] = np.nan
    Q = np.sort(rng.standard_normal((2, 3, 20)), axis=-1)
    Q[1, 2, 9] = np.nan
    ydef = np.linspace(-70.0, 70.0, 20)
    if descending:
        ydef = ydef[::-1].copy()
    dA = np.ones((20, 16))
    idx = [0, 9, 19]
    wc, wm = jlwa.lwa_masks_at(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(dA),
                               jnp.asarray(ydef), idx, increase=increase,
                               variant2=variant2)
    tc, tm = tlwa.lwa_masks_at(torch.as_tensor(q), torch.as_tensor(Q),
                               torch.as_tensor(dA), torch.as_tensor(ydef),
                               torch.as_tensor(idx), increase=increase,
                               variant2=variant2)
    assert tm.shape == (3, 2, 3, 20, 16)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("contours", [12, "list", "tensor"])
@pytest.mark.parametrize("latlon", [False, True])
def test_contour_lengths(pair, contours, latlon):
    """Levels by count (even, module docstring), as a list and as a
    tensor with another tracer; the tensor case hands both packages the
    same levels, an odd count's midpoint included."""
    ja, an, pv = pair
    if contours == "list":
        contours = [-1e-5, 2e-5, 6e-5]
    if contours == "tensor":
        jc = ja.cal_contours(9)
        got = an.cal_contour_lengths(torch.as_tensor(np.array(jc)),
                                     tracer=torch.as_tensor(pv * 2.0),
                                     latlon=latlon)
        want = ja.cal_contour_lengths(jc, tracer=jnp.asarray(pv * 2.0),
                                      latlon=latlon)
    else:
        got = an.cal_contour_lengths(contours, latlon=latlon)
        want = ja.cal_contour_lengths(contours, latlon=latlon)
    _close(got, want, ORDER)


@pytest.mark.parametrize("stride,mode,quirks", [(1, "edge", False),
                                                (2, "wrap", False),
                                                ((1, 3), "edge", True)])
def test_contour_crossing(pair, stride, mode, quirks):
    ja, an, _ = pair
    level = float(np.asarray(ja.cal_contours(9))[0, 4])
    got = an.cal_contour_crossing(level, stride, mode, quirks)
    want = ja.cal_contour_crossing(level, stride, mode, quirks)
    if isinstance(stride, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


@pytest.mark.parametrize("method,rtol", [("cal_contours_at", SAME),
                                         ("cal_contours_at_hist", SAME),
                                         ("cal_contours_at_exact", ORDER)])
def test_contours_at(pair, method, rtol):
    """The facade's 'broadcast', 'hist' and 'exact' levels at prescribed
    latitudes on a facade-built table (the table lookup amplifies the
    integrals' order noise: 1e-10 of the largest level for 'exact', the
    bound of tests/test_torch_sort.py)."""
    ja, an, _ = pair
    mask = np.ones(an.grid.shape)
    jt, tt = ja.cal_area_eqCoord_table_hist(mask), \
        an.cal_area_eqCoord_table_hist(mask)
    pre = np.linspace(-75.0, 75.0, 20)
    _close(getattr(an, method)(pre, tt), getattr(ja, method)(pre, jt),
           rtol if rtol == SAME else 1e-10)


@pytest.mark.parametrize("axis", [-1, 1])
def test_interp_to_coords(pair, axis):
    ja, an, _ = pair
    eq = np.linspace(-60.0, 60.0, 9)[None, :] * np.ones((2, 1))
    var = np.random.default_rng(4).standard_normal((2, 9)).cumsum(-1)
    pre = [-45.0, 0.0, 12.5, 45.0]
    got = an.interp_to_coords(pre, torch.as_tensor(eq), torch.as_tensor(var),
                              axis=axis)
    want = ja.interp_to_coords(pre, jnp.asarray(eq), jnp.asarray(var),
                               axis=axis)
    _close(got, want)


@pytest.mark.parametrize("batch_dims,coords", [((), False),
                                               (("time",), True)])
def test_interp_to_dataset(pair, batch_dims, coords):
    """The labelled merge: the same coordinates, dims and values, and an
    nc3 round trip."""
    ja, an, _ = pair
    pre = np.linspace(-80.0, 80.0, 33)
    out = {}
    for side, A in (("jax", ja), ("torch", an)):
        ctr = A.cal_contours(20)
        tbl = A.cal_area_eqCoord_table_hist(np.ones(an.grid.shape))
        area = A.cal_integral_within_contours_hist(ctr)
        latEq = tbl.lookup_coordinates(area)
        out[side] = A.interp_to_dataset(
            pre, latEq, {"q": ctr, "latEq": latEq, "area": area},
            batch_dims=batch_dims,
            batch_coords={"time": np.array([0.5, 1.5])} if coords else None)
    got, want = out["torch"], out["jax"]
    assert got.dims == want.dims
    assert set(got.coords) == set(want.coords)
    for k in want.coords:
        np.testing.assert_array_equal(got.coords[k], want.coords[k])
    for k in want.variables:
        assert isinstance(got.variables[k], np.ndarray)
        _close(got.variables[k], want.variables[k])


def test_check_mono_raises_only_when_set(pair):
    """check_mono=True: a flat integral (levels past the tracer's range)
    raises ValueError, as the JAX facade's checkify check does; off, the
    same call passes."""
    lat_levels = np.array([[1.0, 2.0, 3.0]] * 2)
    for gen in GENERATIONS:
        ja, an, _ = _pair(gen, check_mono=True)
        with pytest.raises(ValueError, match="not strictly monotonic"):
            ja.cal_integral_within_contours(jnp.asarray(lat_levels))
        for name in ("cal_integral_within_contours",
                     "cal_integral_within_contours_hist",
                     "cal_integral_within_contours_exact"):
            with pytest.raises(ValueError, match="contour-axis values not "
                                                 "strictly monotonic"):
                getattr(an, name)(torch.as_tensor(lat_levels))
        an.cal_area_eqCoord_table(np.ones(an.grid.shape))
        an.cal_area_eqCoord_table_hist(np.ones(an.grid.shape))
        _, off, _ = _pair(gen)
        off.cal_integral_within_contours(torch.as_tensor(lat_levels))


def test_checked_pattern():
    """``err, out = checked(fn)(x); err.throw()``: the pattern of
    tests/test_runner_checks.py, with the function run to its end."""
    ran = []

    def f(a):
        tchecks.check_monotonic(a, name="area")
        ran.append(True)
        return torch.cumsum(a, 0)

    checked = tchecks.checked(f)
    err, out = checked(torch.tensor([1.0, 2.0, 3.0]))
    err.throw()
    assert err.get() is None
    np.testing.assert_array_equal(out.numpy(), [1.0, 3.0, 6.0])
    err, out = checked(torch.tensor([1.0, 1.0, 3.0]))
    assert len(ran) == 2 and out is not None
    with pytest.raises(ValueError, match="area not strictly monotonic"):
        err.throw()


@pytest.mark.parametrize("case", ["monotonic", "direction", "finite_ok",
                                  "finite_bad", "nested"])
def test_checks_match_jax(case):
    """Each check records the JAX check's message inside ``checked`` and
    raises it outside; nested calls record into the innermost."""
    mono = np.array([[1.0, 2.0, 2.0], [0.0, 1.0, 2.0]])
    mixed = np.array([[1.0, 2.0, 3.0], [3.0, 2.0, 1.0]])
    fin = np.array([1.0, np.nan, 3.0, 4.0])
    fin_bad = np.array([1.0, np.nan, np.inf, 4.0])
    calls = {
        "monotonic": (lambda m, x: m.check_monotonic(x, name="v"), mono),
        "direction": (lambda m, x: m.check_uniform_direction(x, name="t"),
                      mixed),
        "finite_ok": (lambda m, x: m.check_finite(x, "f", 0.3), fin),
        "finite_bad": (lambda m, x: m.check_finite(x, "f", 0.3), fin_bad),
        "nested": (lambda m, x: m.check_monotonic(x, name="v"), mono),
    }
    fn, x = calls[case]
    jerr, _ = jchecks.checked(lambda a: fn(jchecks, a))(jnp.asarray(x))
    if case == "nested":
        outer = []

        def inner(a):
            err, _ = tchecks.checked(lambda b: fn(tchecks, b))(a)
            outer.append(err)
        terr, _ = tchecks.checked(inner)(torch.as_tensor(x))
        assert terr.get() is None
        terr = outer[0]
    else:
        terr, _ = tchecks.checked(lambda a: fn(tchecks, a))(torch.as_tensor(x))
    want = jerr.get()
    if want is None:
        assert terr.get() is None
        fn(tchecks, torch.as_tensor(x))
        return
    assert want.startswith(terr.get())
    with pytest.raises(ValueError, match=terr.get().split(" (")[0]):
        fn(tchecks, torch.as_tensor(x))


def test_assert_monotonic_host_matches_jax():
    a = np.array([[0.0, 1.0, 2.0], [0.0, 3.0, 3.0]])
    with pytest.raises(ValueError) as want:
        jchecks.assert_monotonic_host(a, name="tbl")
    with pytest.raises(ValueError) as got:
        tchecks.assert_monotonic_host(torch.as_tensor(a), name="tbl")
    assert str(got.value) == str(want.value)
    tchecks.assert_monotonic_host(torch.arange(4.0))
