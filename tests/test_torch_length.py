"""K7 (marching-squares perimeters), box counting, coarsening and the
fractal dimension: the port against the JAX package on the same numpy
inputs.

Tolerances: float64 K7 plain version against the XLA twin
``_lengths_totals_xla``, 1e-12 relative (summation order only); against
the TPU kernel in interpret mode, rtol 2e-7 (its Maclaurin-series
geodesics, ``test_pallas_kernels.py``'s bound); float32 ``contour_lengths``
2e-6 of each case's largest length (float32 sums of a few hundred
segments in another order); box counting 1e-12 (float64 sums in another
order) and exact on the fuzz-1004 case; coarsening and the fractal fit
1e-12 in float64.  Empty contours (NaN) must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import compat
from xcontour_tpu import core as jcore
from xcontour_tpu.diagnostics import fractal as jfractal
from xcontour_tpu.diagnostics import length as jlength
from xcontour_tpu.kernels.length_pallas import contour_lengths_pallas
from xcontour_tpu.utils import coarsen as jcoarsen
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.diagnostics import length as tlength
from xcontour_tpu_torch.kernels import boxcount
from xcontour_tpu_torch.kernels import length as k7


def _field(rng, B, Ny, Nx):
    d = np.cumsum(rng.normal(size=(B, Ny, Nx)), axis=1)
    return d + 0.3 * rng.normal(size=(B, Ny, Nx))


def _interior_levels(d, N):
    """N levels strictly between each element's min and max (no level tied
    to a corner, where the TPU kernel's reciprocal form leaves ulps)."""
    lo = np.nanmin(d, axis=(-2, -1))
    hi = np.nanmax(d, axis=(-2, -1))
    t = np.linspace(0.0, 1.0, N + 2)[1:-1]
    return lo[:, None] + (hi - lo)[:, None] * t[None]


def _coords(latlon, Ny, Nx, span=(-60.0, 60.0), xspan=(0.0, 348.0)):
    if latlon:
        return (np.deg2rad(np.linspace(*span, Ny)),
                np.deg2rad(np.linspace(*xspan, Nx)))
    return np.linspace(0.0, 1900.0, Ny), np.linspace(0.0, 2900.0, Nx)


def _rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    scale = np.abs(want[m]).max() if m.any() else 1.0
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=rtol * scale)


def _plain(d, levels, y, x, latlon, chunk=8):
    return k7.contour_lengths(*(torch.as_tensor(a) for a in (d, levels, y, x)),
                              latlon=latlon, chunk=chunk).numpy()


def jlength_levels(d, N):
    """The pipelines' levels: endpoint-pinned linspace, NaN for an all-NaN
    element (the JAX ``cal_contours``)."""
    return np.array(jcore.cal_contours(jnp.asarray(d), N))


K7_CASES = ["latlon", "cartesian", "nan_corners", "all_nan_element",
            "decreasing", "shuffled", "coarse_22.5deg"]


@pytest.mark.parametrize("case", K7_CASES)
def test_plain_matches_xla_twin(case):
    rng = np.random.default_rng(K7_CASES.index(case))
    latlon = case != "cartesian"
    B, Ny, Nx, N = 3, 18, 26, 11
    if case == "coarse_22.5deg":
        Ny, Nx = 9, 17
    y, x = _coords(latlon, Ny, Nx)
    if case == "coarse_22.5deg":
        y, x = np.deg2rad(np.linspace(-90, 90, Ny)), np.deg2rad(np.linspace(0, 360, Nx))
    d = _field(rng, B, Ny, Nx)
    if case == "nan_corners":
        d[0, 4, 7] = np.nan
        d[1, 10:13, 3:9] = np.nan
    if case == "all_nan_element":
        d[2] = np.nan
    levels = jlength_levels(d, N)
    if case == "decreasing":
        levels = levels[:, ::-1].copy()
    if case == "shuffled":
        levels = levels[:, rng.permutation(N)]
    want = np.asarray(jlength._lengths_totals_xla(
        jnp.asarray(d), jnp.asarray(levels), jnp.asarray(y), jnp.asarray(x),
        latlon=latlon, chunk=4))
    got = _plain(d, levels, y, x, latlon, chunk=3)
    _rel_close(got, want, 1e-12)
    if case == "all_nan_element":
        assert np.all(np.isnan(levels[2])) and np.all(got[2] == 0.0)


@pytest.mark.parametrize("latlon", [True, False])
@pytest.mark.parametrize("coords", ["shared", "per_element"])
def test_plain_matches_pallas_interpret(latlon, coords):
    rng = np.random.default_rng(11 + latlon)
    B, Ny, Nx, N = 2, 20, 30, 9
    y, x = _coords(latlon, Ny, Nx)
    d = _field(rng, B, Ny, Nx)
    d[0, 4, 7] = np.nan
    levels = _interior_levels(d, N)[:, rng.permutation(N)]
    if coords == "per_element":
        y = np.stack([y, y + 0.01 if latlon else y * 1.5])
        x = np.stack([x + 0.02 if latlon else x * 0.5, x])
    want = np.asarray(contour_lengths_pallas(
        jnp.asarray(d), jnp.asarray(levels), jnp.asarray(y), jnp.asarray(x),
        latlon=latlon, interpret=True))
    got = _plain(d, levels, y, x, latlon)
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-12)
    if coords == "per_element":     # each element against the twin alone
        for b in range(B):
            one = np.asarray(jlength._lengths_totals_xla(
                jnp.asarray(d[b]), jnp.asarray(levels[b]), jnp.asarray(y[b]),
                jnp.asarray(x[b]), latlon=latlon, chunk=8))
            np.testing.assert_allclose(got[b], one, rtol=1e-12)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("latlon", [True, False])
def test_contour_lengths_matches_jax(dt, latlon):
    jdt, tdt = (jnp.float64, torch.float64) if dt == "f64" else \
        (jnp.float32, torch.float32)
    rng = np.random.default_rng(21)
    d = _field(rng, 2, 24, 40)
    d[1, 3:6, 10:14] = np.nan
    ydeg = np.linspace(-70.0, 70.0, 24) if latlon else np.linspace(0, 5e5, 24)
    xdeg = np.linspace(0.0, 351.0, 40) if latlon else np.linspace(0, 8e5, 40)
    levels = jlength_levels(d, 13)
    kw = dict(latlon=latlon)
    want = np.asarray(jlength.contour_lengths(
        jnp.asarray(d, jdt), jnp.asarray(levels, jdt), jnp.asarray(ydeg, jdt),
        jnp.asarray(xdeg, jdt), **kw))
    got = tlength.contour_lengths(
        torch.as_tensor(d).to(tdt), torch.as_tensor(levels).to(tdt),
        torch.as_tensor(ydeg).to(tdt), torch.as_tensor(xdeg).to(tdt), **kw)
    assert got.dtype == tdt
    _rel_close(got.numpy(), want, 1e-12 if dt == "f64" else 2e-6)
    # endpoint-pinned levels: the minimum and the maximum are empty
    assert np.all(np.isnan(want[:, [0, -1]]))


def test_fuzz_500002_tie_follows_the_twin():
    """A level equal to the field minimum totals exactly 0 -> NaN (the
    convex-combination vertices of the twin, fuzz seed 500002)."""
    rng = np.random.default_rng(500002)
    Ny, Nx = 35, 40
    lat = np.linspace(-80.0, 80.0, Ny)
    lon = np.arange(Nx) * (360.0 / Nx)
    f = rng.integers(0, 2, size=(Ny, Nx)).astype(np.float64)
    f += 1e-3 * rng.normal(size=(Ny, Nx))
    f *= 3.2
    f[rng.uniform(size=f.shape) < 0.1] = np.nan
    for N in (1, 5, 23, 24):
        ctr = compat.contours_linspace(f, N, False)
        want = np.asarray(jlength.contour_lengths(
            jnp.asarray(f), jnp.asarray(ctr), jnp.asarray(lat),
            jnp.asarray(lon), latlon=True))
        got = xt.contour_lengths(torch.as_tensor(f), torch.as_tensor(ctr),
                                 torch.as_tensor(lat), torch.as_tensor(lon),
                                 latlon=True).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)


def tie_case(B=256):
    """The seed-7 tie input: B fields of 12x14, normal * U(0.1, 1000) +
    U(-50, 50), levels [min, (min+max)/2, max] per element."""
    rng = np.random.default_rng(7)
    d = rng.normal(size=(B, 12, 14)) * rng.uniform(0.1, 1000.0, (B, 1, 1)) \
        + rng.uniform(-50.0, 50.0, (B, 1, 1))
    lo, hi = d.min(axis=(1, 2)), d.max(axis=(1, 2))
    return d, np.stack([lo, 0.5 * (lo + hi), hi], axis=1)


@pytest.mark.parametrize("latlon", [True, False])
def test_seed7_min_level_tie_follows_the_twin(latlon):
    """At the min level the twin gives NaN in every element; the TPU kernel
    (x * (1/x) edge fractions) leaves a few ulps of length in some; the
    port follows the twin in float64 and float32."""
    d, levels = tie_case()
    y, x = _coords(latlon, 12, 14)
    yd, xd = (np.rad2deg(y), np.rad2deg(x)) if latlon else (y, x)
    want = np.asarray(jlength.contour_lengths(
        jnp.asarray(d), jnp.asarray(levels), jnp.asarray(yd),
        jnp.asarray(xd), latlon=latlon))
    assert np.all(np.isnan(want[:, 0]))
    tpu = np.asarray(contour_lengths_pallas(
        jnp.asarray(d, jnp.float32), jnp.asarray(levels, jnp.float32),
        jnp.asarray(y, jnp.float32), jnp.asarray(x, jnp.float32),
        latlon=latlon, interpret=True))
    assert np.count_nonzero(tpu[:, 0]) > 0       # the TPU kernel's fault
    for dt in (np.float64, np.float32):
        got = xt.contour_lengths(
            *(torch.as_tensor(a.astype(dt)) for a in (d, levels, yd, xd)),
            latlon=latlon).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        raw = _plain(*(a.astype(dt) for a in (d, levels, y, x)), latlon)
        assert np.all(raw[:, 0] == 0.0) and np.all(raw[:, 2] == 0.0)


def _crossing_inputs(seed, Ny=23, Nx=37):
    rng = np.random.default_rng(seed)
    d = _field(rng, 2, Ny, Nx)
    d[0, 5:8, 30:37] = np.nan                   # NaN cells at the x seam
    area = rng.uniform(1.0, 4.0, (Ny, Nx))
    area[3, 4] = np.nan
    return d, area, jlength_levels(d, 7)


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("mode", ["edge", "wrap"])
@pytest.mark.parametrize("stride", [1, 3, [1, 2, 4]])
def test_crossing_matches_jax_and_oracle(quirks, mode, stride):
    d, area, ctr = _crossing_inputs(31)
    want = jlength.contour_crossing(jnp.asarray(d), jnp.asarray(ctr),
                                    jnp.asarray(area), stride, mode=mode,
                                    quirks=quirks)
    got = xt.contour_crossing(torch.as_tensor(d), torch.as_tensor(ctr),
                              torch.as_tensor(area), stride, mode=mode,
                              quirks=quirks)
    if isinstance(stride, list):
        assert isinstance(got, list) and len(got) == len(stride)
        strides = stride
    else:
        strides, want, got = [stride], [want], [got]
    for s, w, g in zip(strides, want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
        for b in range(2):
            for k in range(0, ctr.shape[1], 3):
                o = compat.contour_crossing(d[b], ctr[b, k], area, s,
                                            pad_x=max(strides), mode=mode,
                                            quirks=quirks)
                np.testing.assert_allclose(g[b, k].item(), o, rtol=1e-12)


def test_crossing_quirks_bound_exceeds_width():
    """Fuzz seed 1004: quirks mode asks for more column boxes than the
    padded width holds; the NaN columns reproduce the reference's clamped
    blocks exactly."""
    f = np.zeros((11, 8))
    f[5:] = 1.0
    area = np.full((11, 8), 4.0)
    for quirks in (True, False):
        want = compat.contour_crossing(f, 0.5, area, 2, quirks=quirks)
        got = xt.contour_crossing(torch.as_tensor(f), torch.tensor([0.5],
                                  dtype=torch.float64),
                                  torch.as_tensor(area), 2, quirks=quirks)
        assert float(got[0]) == want, (quirks, float(got[0]), want)


def _table_eval(d, levels, a, strides, quirks):
    """Kernel B's launch table (``kernels.boxcount.plan``) evaluated in
    plain torch, as ``csrc/boxcount.cu`` reads it: each block's tile of one
    field and stride (box rows r0.., columns c0..), each box's points with
    the columns at or past the padded width W as NaN, its weight at
    (r*s, c*s) or under ``quirks`` at (r, c), its levels' sums, and the
    blocks' partials folded in block order.  d (B, Ny, W) and a (Ny, W)
    padded, levels (B, N); returns (B, N, S).  Every box is checked to lie
    in exactly one tile, and no tile to pass the kernel's limits."""
    B, Ny, W = d.shape
    N = levels.shape[-1]
    nan = torch.tensor(float("nan"), dtype=d.dtype)
    table = boxcount.plan(tuple(strides), B, Ny, W, quirks)
    assert sorted(table[:, 1].tolist()) == list(range(len(strides)))
    assert table[:, 0].tolist() == sorted(strides, reverse=True)
    out = torch.full((B, N, len(strides)), float("nan"), dtype=d.dtype)
    first = 0
    for s, col, nrows, ncols, T, R, ntc, nbf, off in table.tolist():
        assert (s, off) == (strides[col], first)
        assert (nrows, ncols) == boxcount.boxes(Ny, W, s, quirks)
        assert T * R <= min(boxcount.TILE_BOXES,
                            max(1, boxcount.TILE_POINTS // (s + 1) ** 2))
        first += B * nbf
        for b in range(B):
            seen = torch.zeros((nrows, ncols), dtype=torch.int64)
            total = torch.zeros(N, dtype=d.dtype)
            for t in range(nbf):
                rb, ct = divmod(t, ntc)
                r0, c0 = rb * R, ct * T
                nr, nc = max(0, min(R, nrows - r0)), max(0, min(T, ncols - c0))
                part = torch.zeros(N, dtype=d.dtype)
                if nr * nc:
                    seen[r0:r0 + nr, c0:c0 + nc] += 1
                    r = torch.arange(r0, r0 + nr)[:, None]
                    c = torch.arange(c0, c0 + nc)[None, :]
                    step = torch.arange(s + 1)
                    ys = (r * s)[..., None, None] + step[:, None]
                    xs = (c * s)[..., None, None] + step[None, :]
                    v = torch.where(xs < W, d[b][ys, xs.clamp(max=W - 1)], nan)
                    isn = torch.isnan(v)
                    lo = torch.where(isn, float("inf"), v).amin((-2, -1))
                    hi = torch.where(isn, float("-inf"), v).amax((-2, -1))
                    ay, ax = (r, c) if quirks else (r * s, c * s)
                    ay, ax = torch.broadcast_tensors(ay, ax)
                    w = torch.where(ax < W, torch.sqrt(a[ay, ax.clamp(max=W - 1)])
                                    * s, nan)
                    w = torch.where(torch.isnan(w), 0.0, w)
                    lev = levels[b][:, None, None]
                    part = torch.where((lo <= lev) & (hi > lev), w,
                                       0.0).sum((-2, -1))
                total = total + part
            assert bool((seen == 1).all()), (s, b)
            out[b, :, col] = total
    assert first == int(table[-1, 8]) + B * int(table[-1, 7])
    return out


def _table_case(seed, Ny, Nx, levels):
    rng = np.random.default_rng(seed)
    d = _field(rng, 2, Ny, Nx)
    d[0, 5:8, Nx - 6:] = np.nan                 # NaN cells at the x seam
    d[1, 20:22, 3:9] = np.nan
    area = rng.uniform(1.0, 4.0, (Ny, Nx))
    area[3, 4] = area[0, Nx - 1] = np.nan
    ctr = jlength_levels(d, 9)
    if levels == "nan_unsorted":
        ctr = ctr[:, rng.permutation(9)]
        ctr[0, 2] = ctr[1, 7] = np.nan
        return d, area, ctr
    if levels == "scalar":                      # a 0-d level, broadcast
        return d, area, np.array(ctr[0, 4])
    return d, area, ctr


@pytest.mark.parametrize("levels", ["sorted", "nan_unsorted", "scalar"])
@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("mode", ["edge", "wrap", "reflect", "symmetric",
                                  "constant"])
@pytest.mark.parametrize("stride", [1, 3, [1, 2, 4, 8, 16, 32]])
def test_box_table_matches_plain_crossing(stride, mode, quirks, levels):
    """Kernel B's launch table evaluated in plain torch equals the plain
    ``contour_crossing`` (float64, rtol 1e-12): per-stride box geometry,
    the ``quirks`` area indexing, columns past the pad read as NaN, NaN
    data, areas and levels, unsorted levels, and a 0-d level broadcast as
    the plain version broadcasts it (``boxcount._levels``)."""
    d, area, ctr = _table_case(17, 70, 45, levels)
    strides = stride if isinstance(stride, list) else [stride]
    want = xt.contour_crossing(torch.as_tensor(d), torch.as_tensor(ctr),
                               torch.as_tensor(area), stride, mode=mode,
                               quirks=quirks)
    want = torch.stack(want if isinstance(stride, list) else [want], -1)
    pad = max(strides)
    dp = tlength._pad_x(torch.as_tensor(d), pad, mode)
    ap = tlength._pad_x(torch.as_tensor(area), pad, mode)
    lev = boxcount._levels(torch.as_tensor(ctr), dp.shape[:-2])
    got = _table_eval(dp, lev, ap, strides, quirks)
    assert got.shape == want.shape
    assert float(want.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("quirks", [False, True])
def test_box_table_quirks_bound_exceeds_width(quirks):
    """The fuzz-1004 shape of test_crossing_quirks_bound_exceeds_width: the
    table's column boxes past the padded width read NaN points and NaN
    areas, as the reference's clamped slices do, exactly."""
    f = np.zeros((1, 11, 8))
    f[:, 5:] = 1.0
    area = np.full((11, 8), 4.0)
    dp = tlength._pad_x(torch.as_tensor(f), 2, "edge")
    ap = tlength._pad_x(torch.as_tensor(area), 2, "edge")
    got = _table_eval(dp, torch.tensor([[0.5]], dtype=torch.float64), ap,
                      [2], quirks)
    want = compat.contour_crossing(f[0], 0.5, area, 2, quirks=quirks)
    assert float(got[0, 0, 0]) == want


def test_box_table_tiles_of_large_strides():
    """A tile of a large stride holds few boxes (its points bound it), the
    columns cut evenly; a stride without boxes takes one empty tile a
    field."""
    table = boxcount.plan((1, 32, 300), 3, 700, 1500, False)
    rows = {r[0]: r for r in table.tolist()}
    assert table[:, 0].tolist() == [300, 32, 1]
    s, _, nrows, ncols, T, R, ntc, nbf, _ = rows[32]
    assert T * R <= boxcount.TILE_POINTS // 33 ** 2 and T * ntc >= ncols
    assert ncols - T * (ntc - 1) > 0
    assert rows[300][4:6] == [1, 1]
    empty = boxcount.plan((40,), 2, 41, 60, False)
    assert empty[0, 2] == 0 and empty[0, 7] == 1


def test_box_counting_area_gradient_matches_jax():
    """Only the area carries a gradient: through the autograd Function (the
    B wrapper forward, the plain VJP a stride at a time) against jax.grad
    of the JAX package's box counting, float64."""
    d, area, ctr = _crossing_inputs(41)
    strides = [1, 2, 4]
    wt = np.random.default_rng(2).uniform(size=(2, ctr.shape[1], 3))

    def jloss(a):
        outs = jlength.contour_crossing(jnp.asarray(d), jnp.asarray(ctr), a,
                                        strides, mode="wrap")
        return sum(jnp.sum(o * wt[..., j]) for j, o in enumerate(outs))
    want = np.asarray(jax.grad(jloss)(jnp.asarray(area)))
    at = torch.tensor(area, requires_grad=True)
    out = tlength.box_counting_lengths(torch.as_tensor(d),
                                       torch.as_tensor(ctr), at, strides,
                                       mode="wrap")
    g, = torch.autograd.grad((out * torch.as_tensor(wt)).sum(), at)
    _rel_close(g.numpy(), want, 1e-12)
    assert np.abs(want[np.isfinite(want)]).max() > 0


@pytest.mark.parametrize("mode", ["edge", "wrap", "reflect", "symmetric",
                                  "constant"])
@pytest.mark.parametrize("n,pad", [(5, 3), (4, 9), (1, 2)])
def test_pad_modes_match_numpy(mode, n, pad):
    a = np.arange(2.0 * n).reshape(2, n) + 1.0
    want = np.pad(a, [(0, 0), (0, pad)], mode=mode)
    got = tlength._pad_x(torch.as_tensor(a), pad, mode).numpy()
    np.testing.assert_array_equal(got, want)


def test_unported_pad_mode_raises():
    """np.pad's function form, and a name np.pad lacks, raise."""
    d, area, ctr = _crossing_inputs(3)
    for mode in (lambda v, w, i, k: None, "mirror"):
        with pytest.raises(ValueError, match="pad mode"):
            xt.contour_crossing(torch.as_tensor(d), torch.as_tensor(ctr),
                                torch.as_tensor(area), 2, mode=mode)


def test_coarsen_matches_jax():
    rng = np.random.default_rng(5)
    f = rng.normal(size=(3, 16, 24))
    f[0, 0:2, 0:2] = np.nan                      # an all-NaN block
    f[1, 5, 7] = np.nan
    for r in (1, 2, 4, 8):
        want = np.asarray(jcoarsen.coarsen(jnp.asarray(f), r))
        got = xt.coarsen(torch.as_tensor(f), r).numpy()
        _rel_close(got, want, 1e-12)
    with pytest.raises(ValueError, match="not divisible"):
        xt.coarsen(torch.as_tensor(f), 5)


def test_loglog_slope_and_fractal_dimension_match_jax():
    rng = np.random.default_rng(6)
    rulers = np.array([1.0, 2.0, 4.0, 8.0]) * 1000.0
    L = 7e6 * (rulers / rulers[0]) ** (1 - rng.uniform(1.0, 1.6, (5, 1)))
    L[1, 2] = np.nan                              # the fit skips it
    L[2, 1:] = np.nan                             # fewer than 2 points: NaN
    L[3] = 7e6                                    # a straight line: D = 1
    want = np.asarray(jfractal.fractal_dimension(jnp.asarray(L),
                                                 jnp.asarray(rulers)))
    got = xt.fractal_dimension(torch.as_tensor(L),
                               torch.as_tensor(rulers)).numpy()
    _rel_close(got, want, 1e-12)
    assert np.isnan(got[2]) and abs(got[3] - 1.0) < 1e-12
    x, y = rng.normal(size=(4, 6)), rng.normal(size=(4, 6))
    x[0, :5] = np.inf
    _rel_close(xt.loglog_slope(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
               np.asarray(jfractal.loglog_slope(jnp.asarray(x), jnp.asarray(y))),
               1e-12)
