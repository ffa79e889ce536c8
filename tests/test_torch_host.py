"""The port's host contour tools (``host/*``), ``viz.py`` and the float64
oracle ``compat.py`` against the JAX package's on the same seeded numpy
inputs; the port's facade against ``compat`` as ``chip_smoke.py`` holds it
on the card.

Tolerances: ``host``, ``compat`` and ``viz`` are numpy copies, so their
outputs are held bit for bit (``assert_array_equal``), tensors given or
numpy arrays; the native marching squares equals the NumPy traversal in its
polylines' vertex counts and to 1e-12 in total length (the JAX suite's
bound); the host traversal's total length equals K7's plain version to
1e-9 in float64 (the JAX suite's bound for its kernel, traversal-free on
both sides but for the per-cell rules).  The float64 facade against
``compat`` at 1e-9 of each output's largest magnitude (the table lookup
amplifies summation-order noise; tests/test_torch_keff_pipeline.py).
"""

import os

import numpy as np
import pytest
import torch

from xcontour_tpu import compat as jcompat
from xcontour_tpu.host import breaking as jbreaking
from xcontour_tpu.host import extract as jextract
from xcontour_tpu.host import native as jnative
from xcontour_tpu.utils.synth import synth_pv
import xcontour_tpu_torch as xt
from xcontour_tpu_torch import compat as tcompat
from xcontour_tpu_torch.host import breaking as tbreaking
from xcontour_tpu_torch.host import extract as textract
from xcontour_tpu_torch.host import native as tnative
from xcontour_tpu_torch.kernels import _build

CPU = "cpu"


def _circle(n=101):
    y = np.linspace(-1, 1, n)
    x = np.linspace(-1, 1, n)
    return y, x, np.hypot(y[:, None], x[None, :])


def _segs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _total(segs):
    return sum(np.sum(np.hypot(np.diff(s[:, 0]), np.diff(s[:, 1])))
               for s in segs)


def test_native_builds_into_the_build_directory():
    """g++ builds csrc/marching.cpp into build/xcontour_tpu_torch/ under a
    digest of the source, not inside either package."""
    lib = tnative._load()
    assert lib is not None, "the C++ traversal should build where g++ is"
    path = tnative._library_path()
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.name.startswith("libmarching_") and path.suffix == ".so"
    pkg = os.path.dirname(os.path.abspath(xt.__file__))
    assert not any(f.endswith(".so") for _, _, fs in os.walk(pkg) for f in fs)


@pytest.mark.parametrize("level,nan_band", [(0.5, False), (0.6, True),
                                            (0.95, False)])
def test_native_matches_numpy_traversal(level, nan_band):
    _, _, r = _circle()
    if nan_band:
        r = r.copy()
        r[:, 45:55] = np.nan
    nat = tnative.find_contours_native(r, level)
    ref = tnative.find_contours_numpy(r, level)
    assert sorted(len(s) for s in nat) == sorted(len(s) for s in ref)
    np.testing.assert_allclose(_total(nat), _total(ref), rtol=1e-12)
    _segs_equal(nat, jnative.find_contours_native(r, level))
    _segs_equal(ref, jnative.find_contours_numpy(r, level))


def test_extraction_handles_all_nan():
    assert tnative.find_contours(np.full((10, 10), np.nan), 0.5) == []


def _pv(seed=4):
    v, _ = synth_pv(nlev=2, nlat=37, nlon=72, seed=seed)
    return (v["latitude"].astype(np.float64),
            v["longitude"].astype(np.float64), v["pv"][0].astype(np.float64))


@pytest.mark.parametrize("tensors", [False, True])
@pytest.mark.parametrize("period", [(None, None), (None, 360.0)])
def test_find_contour_and_lengths_match_jax(tensors, period):
    """find_contour (with ``period=``), both contour_length generations,
    contour_lengths and contour_area, given numpy arrays or tensors."""
    lat, lon, q = _pv()
    T = torch.as_tensor if tensors else (lambda a: a)
    level = float(np.nanpercentile(q, 60))
    got = textract.find_contour(T(q), (T(lat), T(lon)), level, period=period)
    want = jextract.find_contour(q, (lat, lon), level, period=period)
    _segs_equal(got, want)
    for g, w in zip(got, want):
        assert textract.contour_length(T(g), latlon=True) == \
            jextract.contour_length(w, latlon=True)
        assert textract.contour_area(T(g)) == jextract.contour_area(w)
    idx = tnative.find_contours(q, level)
    assert textract.contour_length(idx, T(np.deg2rad(lon)),
                                   T(np.deg2rad(lat)), latlon=True) == \
        jextract.contour_length(idx, np.deg2rad(lon), np.deg2rad(lat),
                                latlon=True)
    levels = np.nanpercentile(q, [20, 50, 80])
    np.testing.assert_array_equal(
        textract.contour_lengths(T(q), T(levels), dims=(T(lat), T(lon)),
                                 period=period),
        jextract.contour_lengths(q, levels, dims=(lat, lon), period=period))
    np.testing.assert_array_equal(
        textract.contour_lengths(T(q), levels, latlon=False),
        jextract.contour_lengths(q, levels, latlon=False))


def test_host_total_matches_k7():
    """The traversal's total length of every piece at a level equals K7's
    (plain version, float64) on the same field, neither wrapping x: the
    cross-check chip_smoke.py makes against the kernel on the card."""
    lat, lon, q = _pv(6)
    for level in np.nanpercentile(q, [35, 65]):
        host = sum(textract.contour_length(s, latlon=True)
                   for s in textract.find_contour(q, (lat, lon), level))
        k7 = xt.contour_lengths(torch.as_tensor(q), torch.tensor([level]),
                                torch.as_tensor(lat), torch.as_tensor(lon),
                                latlon=True)
        np.testing.assert_allclose(host, k7[0].item(), rtol=1e-9)


def test_breaking_chain_matches_jax():
    """extract -> snap -> group -> select on a circumpolar wavy contour
    crossing the seam, tensors in; and the chain's parts."""
    nlat, nlon = 91, 180
    lat = np.linspace(-89, 89, nlat)
    lon = np.linspace(0, 358, nlon)
    phi, lam = np.deg2rad(lat)[:, None], np.deg2rad(lon)[None, :]
    pv = np.sin(phi) + 0.15 * np.cos(phi) ** 2 * np.sin(3 * lam)
    kw = dict(level=0.5, y_overlap=3.0, x_extent=0.9)
    for snap in (True, False):
        got = tbreaking.breaking_contour(torch.as_tensor(pv),
                                         torch.as_tensor(lat),
                                         torch.as_tensor(lon), snap=snap, **kw)
        want = jbreaking.breaking_contour(pv, lat, lon, snap=snap, **kw)
        np.testing.assert_array_equal(got, want)
    cs = tbreaking.extract_contours(pv, lat, lon, 0.5)
    _segs_equal(cs, jbreaking.extract_contours(pv, lat, lon, 0.5))
    snapped = tbreaking.rescale_contours(cs, lat, lon)
    _segs_equal(snapped, jbreaking.rescale_contours(cs, lat, lon))
    grouped = tbreaking.group_contours(snapped, 3.0, (0.0, 358.0))
    _segs_equal(grouped, jbreaking.group_contours(snapped, 3.0, (0.0, 358.0)))
    _segs_equal(tbreaking.filter_contours(grouped, lon, 0.5),
                jbreaking.filter_contours(grouped, lon, 0.5))
    np.testing.assert_array_equal(tbreaking.single_contour(grouped, lon),
                                  jbreaking.single_contour(grouped, lon))


def test_df_contours_matches_jax():
    pd = pytest.importorskip("pandas")
    cs = [np.array([[0.0, 10.0], [5.0, 12.0]]), np.array([[7.0, 20.0]])]
    for arg in (cs, cs[0], []):
        got, want = tbreaking.df_contours(arg), jbreaking.df_contours(arg)
        assert isinstance(got, pd.DataFrame)
        assert got.equals(want)


COMPAT_CALLS = {
    "contours_linspace": lambda c, f: c.contours_linspace(f["q"], 17, False),
    "histogram_cdf": lambda c, f: c.histogram_cdf(
        f["q"], c.contours_linspace(f["q"], 13), f["dA"], True),
    "integral": lambda c, f: c.integral_within_contours(
        f["q"], c.contours_linspace(f["q"], 13), f["dA"], f["w"], False),
    "integral_hist": lambda c, f: c.integral_within_contours_hist(
        f["q"], c.contours_linspace(f["q"], 13), f["dA"], None, True),
    "area_table": lambda c, f: c.area_table_broadcast(
        f["mask"], f["lat"], f["dA"], True, True),
    "area_table_hist": lambda c, f: c.area_table_hist(
        f["mask"], f["lat"], f["dA"], False, True),
    "gradient_wrt_area": lambda c, f: c.gradient_wrt_area(
        np.cumsum(f["w"][0]), np.cumsum(f["dA"][0])),
    "lwa": lambda c, f: c.local_wave_activity(
        f["q"], f["Q"], f["dA"], f["lat"], True, "all"),
    "lwa2_upper": lambda c, f: c.local_wave_activity2(
        f["q"], f["Q"], f["dA"], f["lat"], False, "upper"),
    "lengths": lambda c, f: c.contour_lengths(
        f["q"], c.contours_linspace(f["q"], 9), f["lat"], f["lon"], True),
    "crossing": lambda c, f: c.contour_crossing(
        f["q"], float(np.nanmedian(f["q"])), f["dA"], 2),
    "equivalent_latitudes": lambda c, f: c.equivalent_latitudes(
        np.linspace(0.0, 5e14, 9)),
    "squared_gradient": lambda c, f: c.squared_gradient(
        f["q"], f["lat"], f["lon"]),
    "keff_snapshot": lambda c, f: c.keff_snapshot(
        f["q"], f["w"], f["lat"], f["dA"], f["dxF"], f["mask"],
        np.linspace(-80.0, 80.0, 9), N=21),
    "lwa_snapshot": lambda c, f: c.lwa_snapshot(
        f["q"], f["lat"], f["dA"], f["mask"], N=21),
    "lwa_production": lambda c, f: c.lwa_production_snapshot(
        f["q"], f["w"], f["lat"], f["dA"], f["mask"], N=21),
}


def _compat_inputs():
    lat, lon, q = _pv(8)
    q[3:6, 10:14] = np.nan
    g = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    rng = np.random.default_rng(1)
    mask = np.ones(q.shape)
    mask[2, :5] = 0.0
    return dict(q=q, lat=lat, lon=lon, dA=g.dA.numpy(), dxF=g.dxF.numpy(),
                w=rng.uniform(0.5, 2.0, q.shape), mask=mask,
                Q=np.sort(np.nanmean(q, axis=-1)))


def _flatten(out):
    if isinstance(out, dict):
        return {f"{k}/{k2}": v2 for k, v in out.items()
                for k2, v2 in _flatten(v).items()}
    if isinstance(out, tuple):
        return {str(i): v for i, v in enumerate(out)}
    return {"": out}


@pytest.mark.parametrize("name", sorted(COMPAT_CALLS))
def test_compat_is_bit_for_bit(name):
    f = _compat_inputs()
    got = _flatten(COMPAT_CALLS[name](tcompat, f))
    want = _flatten(COMPAT_CALLS[name](jcompat, f))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      k)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    return np.abs(got[m] - want[m]).max() / np.abs(want[m]).max()


def test_facade_against_compat_oracle():
    """The float64 facade's Keff and LWA chains on one snapshot against
    ``compat.keff_snapshot``/``lwa_snapshot``: the oracle chip_smoke.py
    holds the card's facade to (there at float32 tolerances)."""
    f = _compat_inputs()
    q = np.nan_to_num(f["q"], nan=float(np.nanmean(f["q"])))
    lat, lon = f["lat"], f["lon"]
    _, grid = xt.add_latlon_metrics({"latitude": lat, "longitude": lon},
                                    dtype=torch.float64, device=CPU)
    an = xt.Contour2D(grid, q[None], lt=True, dtype=torch.float64)
    N, pre = 21, np.linspace(-80.0, 80.0, 9)
    grdS = xt.squared_gradient(an.tracer, grid)
    want = tcompat.keff_snapshot(q, grdS[0].numpy(), lat, grid.dA.numpy(),
                                 grid.dxF.numpy(), np.ones(q.shape), pre,
                                 N=N, lmin="analytic")["origin"]
    ctr = an.cal_contours(N)
    table = an.cal_area_eqCoord_table_hist(np.ones(q.shape))
    area = an.cal_integral_within_contours_hist(ctr)
    intS = an.cal_integral_within_contours_hist(ctr, integrand=grdS)
    yeq = table.lookup_coordinates(area)
    leq2 = an.cal_sqared_equivalent_length(
        an.cal_gradient_wrt_area(intS, area), an.cal_gradient_wrt_area(ctr,
                                                                       area))
    nkeff = an.cal_normalized_Keff(leq2, xt.latitude_lengths_at(yeq), 2e7)
    for key, val in (("intArea", area), ("Yeq", yeq), ("Leq2", leq2),
                     ("nkeff", nkeff)):
        assert _rel(val[0].numpy(), want[key]) < 1e-9, key
    lwa_want = tcompat.lwa_snapshot(q, lat, grid.dA.numpy(), np.ones(q.shape),
                                    N=N)
    Q = an.interp_to_coords(grid.ydef, yeq, ctr)
    assert _rel(Q[0].numpy(), lwa_want["Q"]) < 1e-9
    got = an.cal_local_wave_activity(an.tracer,
                                     torch.as_tensor(lwa_want["Q"])[None])
    assert _rel(got[0].numpy(), lwa_want["lwa"]) < 1e-9
    got2 = an.cal_local_wave_activity2(an.tracer,
                                       torch.as_tensor(lwa_want["Q"])[None])
    assert _rel(got2[0].numpy(), lwa_want["lwa2"]) < 1e-9


# -- viz ---------------------------------------------------------------------

@pytest.fixture()
def viz():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt
    from xcontour_tpu import viz as jviz
    from xcontour_tpu_torch import viz as tviz
    yield jviz, tviz
    plt.close("all")


def _artists(ax):
    return dict(lines=[np.asarray(ln.get_xydata()) for ln in ax.lines],
                collections=len(ax.collections),
                labels=(ax.get_xlabel(), ax.get_ylabel()))


def _same_artists(a, b):
    assert a["collections"] == b["collections"]
    assert a["labels"] == b["labels"]
    assert len(a["lines"]) == len(b["lines"])
    for x, y in zip(a["lines"], b["lines"]):
        np.testing.assert_array_equal(x, y)


def test_viz_helpers_take_tensors(viz):
    """Each of the four figure helpers given tensors draws the same artists
    as the JAX package's given numpy arrays."""
    jviz, tviz = viz
    T = torch.as_tensor
    lat, lon, q = _pv(9)
    poly = np.stack([np.linspace(0, 350, 50),
                     10 * np.sin(np.linspace(0, 2 * np.pi, 50))], axis=1)
    _same_artists(_artists(tviz.plot_field(T(q), T(lat), T(lon),
                                           contours=[T(poly)])),
                  _artists(jviz.plot_field(q, lat, lon, contours=[poly])))
    nk = np.abs(np.random.default_rng(2).standard_normal((3, 11))) + 0.1
    nk[1, 4] = np.nan
    yeq = np.linspace(-80.0, 80.0, 11)
    for n, y in ((nk, yeq), (nk[0], yeq)):
        _same_artists(_artists(tviz.plot_keff(T(n), T(y))),
                      _artists(jviz.plot_keff(n, y)))
    L = np.linspace(1e6, 3e7, 11)
    L[3] = np.nan
    _same_artists(
        _artists(tviz.plot_length_spectrum(T(L), T(yeq),
                                           min_length=torch.tensor(2e6))),
        _artists(jviz.plot_length_spectrum(L, yeq, min_length=2e6)))
    _same_artists(
        _artists(tviz.plot_sorted_profile(T(q), T(lat), T(yeq), T(yeq))),
        _artists(jviz.plot_sorted_profile(q, lat, yeq, yeq)))
