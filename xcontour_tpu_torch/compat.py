"""NumPy twin of the reference semantics — the golden-test oracle.

A copy of ``xcontour_tpu/compat.py``: the port's own float64 oracle, which
also runs where the JAX package cannot be imported (the GPU machine).

The reference (miniufo/xcontour) has no assertion-based tests; its de-facto
correctness oracle is cross-path parity between the xarray-broadcast and
xhistogram code paths (reference tests/test_hist.py:132-167).  This module
re-states those semantics in plain float64 NumPy, *independently* of the JAX
engine and of the port, so either can be validated against it at tight
tolerances.  Each function documents the reference source it mirrors
(file:line in the reference checkout).

Everything here operates on single 2-D snapshots (Ny, Nx); tests loop batches
in Python.  This code is intentionally simple and slow — it is an oracle and
the CPU baseline for benchmarks, not a compute path.
"""

from __future__ import annotations

import numpy as np

from .utils.constants import Rearth as _REARTH

__all__ = [
    "contours_linspace", "histogram_cdf", "integral_within_contours",
    "integral_within_contours_hist", "area_table_broadcast", "area_table_hist",
    "table_lookup_coordinates", "table_lookup_values", "gradient_wrt_area",
    "interp_to_coords", "local_wave_activity", "local_wave_activity2",
    "contour_lengths", "contour_crossing", "equivalent_latitudes",
    "latitude_lengths_at", "squared_gradient",
]


# ----------------------------------------------------------------------------
# contour level generation — reference core.py:205-266
# ----------------------------------------------------------------------------
def contours_linspace(tracer: np.ndarray, N: int, increase: bool = True) -> np.ndarray:
    """N equally-spaced levels between the snapshot's (nan-)min and max.

    If ``increase`` the levels run min->max, else max->min
    (reference core.py:222-249 ``mylinspace``).
    """
    mmin = np.nanmin(tracer)
    mmax = np.nanmax(tracer)
    start, end = (mmin, mmax) if increase else (mmax, mmin)
    # N == 1 / all-NaN inputs produce inf/NaN levels by design (reference
    # semantics); scope the errstate so expected degenerates don't bury real
    # regressions in pytest warning noise
    with np.errstate(divide="ignore", invalid="ignore"):
        steps = (end - start) / (N - 1.0)
        levels = steps * np.arange(N) + start
    # pin the endpoint exactly (np.linspace semantics); the reference's open
    # formula can drop the extreme cell from every >=-CDF by 1 ulp
    levels[-1] = end
    return levels


# ----------------------------------------------------------------------------
# weighted-histogram CDF engine — reference core.py:1202-1325 ``_histogram``
# ----------------------------------------------------------------------------
def histogram_cdf(var: np.ndarray, bins: np.ndarray, weights: np.ndarray,
                  lt: bool) -> np.ndarray:
    """Weighted-histogram CDF with the reference's edge semantics.

    * one extra bin of width ``step`` is prepended so the output has the same
      length as ``bins`` (core.py:1277-1305);
    * decreasing bins are reversed for histogramming and the output is mapped
      back so ``out[k]`` corresponds to ``bins[k]`` (core.py:1289-1313 plus the
      index-restoring reversal in core.py:453-455);
    * ``lt=False`` flips the CDF via total - CDF (core.py:1322-1324);
    * NaN weights are zeroed (core.py:449), NaN values fall outside all bins.
    """
    b = np.asarray(bins, np.float64)
    N = b.shape[0]
    if N > 1 and not np.all(np.diff(b)):
        raise ValueError("non monotonic bins")
    bincrease = b[0] < b[-1]
    asc = b if bincrease else b[::-1]
    step = (asc[-1] - asc[0]) / (N - 1)
    edges = np.concatenate([[asc[0] - step], asc])

    w = np.where(np.isnan(weights), 0.0, weights)
    v = np.asarray(var, np.float64)
    valid = ~np.isnan(v)
    hist, _ = np.histogram(v[valid], bins=edges,
                           weights=np.broadcast_to(w, v.shape)[valid].astype(np.float64))
    cdf = np.cumsum(hist)
    if not lt:
        cdf = cdf[-1] - cdf
    return cdf if bincrease else cdf[::-1]


# ----------------------------------------------------------------------------
# conditional integrals — reference core.py:363-460
# ----------------------------------------------------------------------------
def integral_within_contours(tracer: np.ndarray, contours: np.ndarray, dA: np.ndarray,
                             integrand: np.ndarray | None = None,
                             lt: bool = False) -> np.ndarray:
    """Broadcast path: mask ``integrand`` where tracer </> each contour, then
    nan-skipping area integral (core.py:398-404)."""
    if integrand is None:
        integrand = tracer - tracer + 1.0  # NaN stays NaN, like the reference
    q = np.asarray(tracer, np.float64)
    f = np.asarray(integrand, np.float64)
    out = np.empty(len(contours))
    for k, c in enumerate(np.asarray(contours, np.float64)):
        cond = (q < c) if lt else (q > c)  # NaN compares False => excluded
        msk = np.where(cond, f, np.nan)
        out[k] = np.nansum(msk * dA)
    return out


def integral_within_contours_hist(tracer: np.ndarray, contours: np.ndarray,
                                  dA: np.ndarray, integrand: np.ndarray | None = None,
                                  lt: bool = False) -> np.ndarray:
    """Histogram path: weights = integrand * dA, NaN->0 (core.py:412-460)."""
    wei = dA if integrand is None else np.asarray(integrand, np.float64) * dA
    return histogram_cdf(tracer, contours, wei, lt)


# ----------------------------------------------------------------------------
# area <-> equivalent-coordinate tables — reference core.py:73-203
# ----------------------------------------------------------------------------
def area_table_broadcast(mask: np.ndarray, ydef: np.ndarray, dA: np.ndarray,
                         increase: bool, lt: bool):
    """Conditional-integration table A(y) with the 4-way lt x direction case
    split (core.py:103-128) and the maxArea endpoint overwrite
    (core.py:133-142).  Returns (coords, values) with coords == ydef order."""
    y = np.asarray(ydef, np.float64)
    eq_dim_incre = y[-1] > y[0]
    ctr_var = np.broadcast_to(y[:, None], mask.shape)  # y value at each cell

    use_lt_cmp = (eq_dim_incre == increase) if lt else (eq_dim_incre != increase)
    tbl = np.empty(y.shape[0])
    m = np.asarray(mask, np.float64)
    for j in range(y.shape[0]):
        cond = (ctr_var < y[j]) if use_lt_cmp else (ctr_var > y[j])
        tbl[j] = abs(np.nansum(np.where(cond, m, np.nan) * dA))
    max_area = abs(np.nansum(m * dA))
    if tbl[-1] > tbl[0]:
        tbl[-1] = max_area
    else:
        tbl[0] = max_area
    return y, tbl


def area_table_hist(mask: np.ndarray, ydef: np.ndarray, dA: np.ndarray,
                    increase: bool, lt: bool):
    """Histogram table: histogram the (masked) y-coordinate field itself with
    dA weights (core.py:150-203).  Returns (coords, values) with coords always
    ascending, matching the reference's re-labelling (core.py:195-198)."""
    y = np.asarray(ydef, np.float64)
    y_incre = not (y[-1] < y[0])
    ylt = lt if (increase == y_incre) else (not lt)
    ctr_var = np.broadcast_to(y[:, None], mask.shape)
    ctr_var = np.where(np.asarray(mask) == 1, ctr_var, np.nan)  # core.py:178
    cdf = histogram_cdf(ctr_var, y, dA, ylt)
    # histogram_cdf maps out[k] <-> bins[k]=y[k]; the reference instead leaves
    # the data in ascending-bin order and labels it with ascending y — same
    # pairing, so just sort to ascending order here:
    if y_incre:
        return y, cdf
    return y[::-1], cdf[::-1]


def table_lookup_coordinates(table_values: np.ndarray, coords: np.ndarray,
                             values: np.ndarray) -> np.ndarray:
    """Table y=F(x): given values (y), return coordinates (x), direction-aware
    (reference core.py:1136-1174 + _interp1d core.py:1405-1434)."""
    inc_vl = table_values[-1] > table_values[0]
    if inc_vl:
        return np.interp(values, table_values, coords)
    return np.interp(values, table_values[::-1], coords[::-1])


def table_lookup_values(table_values: np.ndarray, coords: np.ndarray,
                        x: np.ndarray) -> np.ndarray:
    """Inverse lookup (the reference's ``lookup_values`` intends this but is
    broken by the ``self._vables`` typo, core.py:1190; fixed by construction)."""
    inc_cd = coords[-1] > coords[0]
    if inc_cd:
        return np.interp(x, coords, table_values)
    return np.interp(x, coords[::-1], table_values[::-1])


# ----------------------------------------------------------------------------
# contour-space calculus — reference core.py:463-488, 1017-1100
# ----------------------------------------------------------------------------
def gradient_wrt_area(var: np.ndarray, area: np.ndarray) -> np.ndarray:
    """Centered derivative along the uniform contour index, edge one-sided —
    xarray's .differentiate('contour') == np.gradient with unit spacing
    (core.py:479-483).  Flat-area stretches divide 0/0 -> NaN by design
    (reference semantics); errstate-scoped so the expected degenerates stay
    out of the pytest warning summary."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.gradient(np.asarray(var, np.float64), axis=-1) / \
            np.gradient(np.asarray(area, np.float64), axis=-1)


def interp_to_coords(predef: np.ndarray, eq_coords: np.ndarray,
                     var: np.ndarray, increasing: bool | None = None) -> np.ndarray:
    """Remap a contour-indexed variable onto prescribed coordinate values via
    1-D monotone interp, direction-aware (core.py:1050-1100)."""
    if increasing is None:
        increasing = eq_coords[0] < eq_coords[-1]
    if increasing:
        return np.interp(predef, eq_coords, var)
    return np.interp(predef, eq_coords[::-1], var[::-1])


# ----------------------------------------------------------------------------
# local finite-amplitude wave activity — reference core.py:696-905
# ----------------------------------------------------------------------------
def _lwa_masks(qe: np.ndarray, m: np.ndarray, increase: bool) -> np.ndarray:
    """3-valued mask (core.py:759-766): -1 where the deviation sticks out below
    the surface, +1 where it sticks out above, 0 elsewhere."""
    if increase:
        mask1 = np.where(qe > 0, -1.0, 0.0)
        mask2 = np.where(m, 0.0, mask1)
        return np.where((qe < 0) & m, 1.0, mask2)
    mask1 = np.where(qe < 0, -1.0, 0.0)
    mask2 = np.where(m, 0.0, mask1)
    return np.where((qe > 0) & m, 1.0, mask2)


def _lwa_part_select(mask3: np.ndarray, part: str, increase: bool) -> np.ndarray:
    """W+/W-/all region selection (core.py:772-784); returns NaN outside."""
    if part == "all":
        return mask3
    if part == "upper":
        keep = mask3 > 0 if increase else mask3 < 0
    elif part == "lower":
        keep = mask3 < 0 if increase else mask3 > 0
    else:
        raise ValueError("part must be in ['all', 'upper', 'lower']")
    return np.where(keep, mask3, np.nan)


def local_wave_activity(q: np.ndarray, Q: np.ndarray, dA: np.ndarray,
                        ydef: np.ndarray, increase: bool,
                        part: str = "all", weight=None) -> np.ndarray:
    """LWA (Huang-Nakamura 2016) loop form, reference core.py:696-799:
    for each eq-dim surface j, LWA_j(x) = -sum_y qe*mask*wei*dA with
    wei = dA/max(dA) (core.py:723-724, 789).  ``weight`` overrides the full
    composed weight W = wei*dA (e.g. wei*dy for m/s units)."""
    q = np.asarray(q, np.float64)
    Q = np.asarray(Q, np.float64)
    y = np.asarray(ydef, np.float64)
    if weight is not None:
        dA = np.ones_like(dA)
        wei = weight
    else:
        wei = dA / np.nanmax(dA)
    coord_incre = not (y[-1] < y[0])
    Ny = y.shape[0]
    lwa = np.empty_like(q)
    for j in range(Ny):
        qe = q - Q[j]
        m = (y >= y[j]) if coord_incre else (y <= y[j])
        mask3 = _lwa_masks(qe, m[:, None], increase)
        mask_final = _lwa_part_select(mask3, part.lower(), increase)
        lwa[j] = -np.nansum(qe * mask_final * wei * dA, axis=0)
    return lwa


def local_wave_activity2(q: np.ndarray, Q: np.ndarray, dA: np.ndarray,
                         ydef: np.ndarray, increase: bool,
                         part: str = "all", weight=None) -> np.ndarray:
    """Impulse-Casimir variant, reference core.py:802-905: qe = q_j - Q and the
    increase branches swapped (core.py:860-872)."""
    q = np.asarray(q, np.float64)
    Q = np.asarray(Q, np.float64)
    y = np.asarray(ydef, np.float64)
    if weight is not None:
        dA = np.ones_like(dA)
        wei = weight
    else:
        wei = dA / np.nanmax(dA)
    coord_incre = not (y[-1] < y[0])
    Ny = y.shape[0]
    lwa = np.empty_like(q)
    for j in range(Ny):
        qe = q[j][None, :] - Q[:, None]          # (Ny, Nx)
        m = (y >= y[j]) if coord_incre else (y <= y[j])
        mask3 = _lwa_masks(qe, m[:, None], not increase)
        # part selection still keys off the *original* increase flag
        # (core.py:879-890)
        mask_final = _lwa_part_select(mask3, part.lower(), increase)
        lwa[j] = -np.nansum(qe * mask_final * wei * dA, axis=0)
    return lwa


# ----------------------------------------------------------------------------
# contour perimeter lengths — reference core.py:969-1014, 1437-1487 +
# utils.py:565-609, 705-761 (skimage marching squares + geodesic polylines)
# ----------------------------------------------------------------------------
def _haversine(lon1, lon2, lat1, lat2):
    """Great-circle distance on the unit sphere, radians in
    (reference utils.py:734-761)."""
    dlon = lon2 - lon1
    dlat = lat2 - lat1
    a = np.sin(dlat / 2.0) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2.0) ** 2
    return 2.0 * np.arcsin(np.sqrt(a))


def _cells_total_length(data: np.ndarray, level: float, ycoord: np.ndarray,
                        xcoord: np.ndarray, latlon: bool) -> float:
    """Traversal-free marching squares: per-cell segment geometry summed.

    Total perimeter is traversal-invariant, so only per-cell geometry matters.
    Vertex positions use linear interpolation identical to
    skimage.measure.find_contours; the ambiguous (saddle) cases follow
    skimage's default fully_connected='low' rule: corners above the level are
    cut off individually.
    """
    v00 = data[:-1, :-1]
    v01 = data[:-1, 1:]
    v10 = data[1:, :-1]
    v11 = data[1:, 1:]
    nan_cell = (np.isnan(v00) | np.isnan(v01) | np.isnan(v10) | np.isnan(v11))
    a00 = v00 > level
    a01 = v01 > level
    a10 = v10 > level
    a11 = v11 > level

    def frac(va, vb):
        d = vb - va
        with np.errstate(divide="ignore", invalid="ignore"):
            f = (level - va) / d
        return np.where(d == 0, 0.0, f)

    Ny1, Nx1 = v00.shape
    ygrid = ycoord[:, None] if ycoord.ndim == 1 else ycoord
    y0 = np.broadcast_to(ycoord[:-1, None], (Ny1, Nx1))
    y1 = np.broadcast_to(ycoord[1:, None], (Ny1, Nx1))
    x0 = np.broadcast_to(xcoord[None, :-1], (Ny1, Nx1))
    x1 = np.broadcast_to(xcoord[None, 1:], (Ny1, Nx1))

    # edge-crossing vertex physical coordinates
    ft = frac(v00, v01)
    fb = frac(v10, v11)
    fl = frac(v00, v10)
    fr = frac(v01, v11)

    def lerp(f, c0, c1):
        # convex combination: tie fractions (0/1) land bitwise on corners.
        # The reference itself is exact there — skimage interpolates in
        # INTEGER index space (f==1 gives r+1 exactly) and the index->coord
        # np.interp then returns the exact grid coordinate — so a tied level
        # must contribute exactly zero length (-> the NaN empty rule), which
        # `c0 + f*(c1-c0)` breaks by an ulp on offset coordinates.
        return (1.0 - f) * c0 + f * c1

    top = (y0, lerp(ft, x0, x1))
    bot = (y1, lerp(fb, x0, x1))
    lef = (lerp(fl, y0, y1), x0)
    rig = (lerp(fr, y0, y1), x1)

    def seglen(p, q):
        if latlon:
            return _haversine(p[1], q[1], p[0], q[0])
        return np.hypot(p[0] - q[0], p[1] - q[1])

    # segment-per-case lengths
    L = np.zeros((Ny1, Nx1))
    # isolated single corner (or its 3-corner complement)
    iso00 = (a00 != a01) & (a00 != a10) & (a01 == a11)
    iso01 = (a01 != a00) & (a01 != a11) & (a00 == a10)
    iso10 = (a10 != a00) & (a10 != a11) & (a00 == a01)
    iso11 = (a11 != a01) & (a11 != a10) & (a01 == a00)
    L = np.where(iso00, seglen(top, lef), L)
    L = np.where(iso01, seglen(top, rig), L)
    L = np.where(iso10, seglen(bot, lef), L)
    L = np.where(iso11, seglen(bot, rig), L)
    # adjacent pairs
    horiz = (a00 == a01) & (a10 == a11) & (a00 != a10)
    verti = (a00 == a10) & (a01 == a11) & (a00 != a01)
    L = np.where(horiz, seglen(lef, rig), L)
    L = np.where(verti, seglen(top, bot), L)
    # saddles: high corners cut off individually (fully_connected='low')
    sad_main = a00 & a11 & ~a01 & ~a10
    sad_anti = a01 & a10 & ~a00 & ~a11
    L = np.where(sad_main, seglen(top, lef) + seglen(bot, rig), L)
    L = np.where(sad_anti, seglen(top, rig) + seglen(bot, lef), L)

    L = np.where(nan_cell, 0.0, L)
    total = float(np.sum(L))
    del ygrid
    return total


def contour_lengths(data: np.ndarray, contours: np.ndarray, ydef: np.ndarray,
                    xdef: np.ndarray, latlon: bool = True,
                    Rearth: float = _REARTH) -> np.ndarray:
    """Perimeter of each contour level (reference core.py:969-1014 +
    utils.py:565-609).  latlon: coords in degrees -> radians -> haversine * R;
    cartesian: hypot.  Zero total length returns NaN (utils.py:603-604)."""
    if latlon:
        yc = np.deg2rad(np.asarray(ydef, np.float64))
        xc = np.deg2rad(np.asarray(xdef, np.float64))
    else:
        yc = np.asarray(ydef, np.float64)
        xc = np.asarray(xdef, np.float64)
    d = np.asarray(data, np.float64)
    out = np.empty(len(contours))
    for k, c in enumerate(contours):
        total = _cells_total_length(d, float(c), yc, xc, latlon)
        if total == 0.0:
            out[k] = np.nan
        else:
            out[k] = total * Rearth if latlon else total
    return out


# ----------------------------------------------------------------------------
# box-counting crossing length — reference core.py:640-693, 1490-1566
# ----------------------------------------------------------------------------
def contour_crossing(data: np.ndarray, contour: float, area: np.ndarray,
                     stride: int = 1, pad_x: int | None = None,
                     mode: str = "edge", quirks: bool = False) -> float:
    """Box-counting length: boxes whose values straddle the contour contribute
    sqrt(area)*stride (core.py:1490-1566).

    ``quirks=True`` replicates the reference bit-for-bit, including its
    latent bugs (SURVEY.md §0.2): the inner column loop is bounded by the ROW
    count, and the contributing area is indexed by box index rather than grid
    index.  ``quirks=False`` fixes both: full-width coverage and
    grid-indexed areas.
    """
    if pad_x is None:
        pad_x = stride if isinstance(stride, int) else max(stride)
    d = np.pad(np.asarray(data, np.float64), ((0, 0), (0, pad_x)), mode=mode)
    a = np.pad(np.asarray(area, np.float64), ((0, 0), (0, pad_x)), mode=mode)

    jj, nn = d.shape
    Jn = int(np.round(jj / stride))
    In = int(np.round(nn / stride))
    total = 0.0
    i_bound = (Jn - 1) if quirks else (In - 1)
    for j in range(Jn - 1):
        jstr = j * stride
        for i in range(i_bound):
            istr = i * stride
            block = d[jstr:jstr + stride + 1, istr:istr + stride + 1]
            finite = block[~np.isnan(block)]
            if finite.size == 0:
                continue
            le = np.any(finite <= contour)
            gt = np.any(finite > contour)
            if le and gt:
                cell_area = a[j, i] if quirks else a[jstr, istr]
                if not np.isnan(cell_area):
                    total += np.sqrt(cell_area) * stride
    return total


# ----------------------------------------------------------------------------
# geometry / gradient helpers used by the reference's scripts
# ----------------------------------------------------------------------------
def equivalent_latitudes(areas: np.ndarray, Rearth: float = _REARTH) -> np.ndarray:
    """reference utils.py:491-515."""
    ratio = areas / (2.0 * np.pi * Rearth * Rearth) - 1.0
    ratio = np.clip(ratio, -1.0, 1.0)
    return np.rad2deg(np.arcsin(ratio))


def latitude_lengths_at(lats: np.ndarray, Rearth: float = _REARTH) -> np.ndarray:
    """reference utils.py:518-534."""
    return 2.0 * np.pi * Rearth * np.cos(np.deg2rad(lats))


def keff_snapshot(tracer: np.ndarray, grdS: np.ndarray, ydef: np.ndarray,
                  dA: np.ndarray, dxF: np.ndarray, mask: np.ndarray,
                  pre_y: np.ndarray, N: int = 251, increase: bool = True,
                  lt: bool = True, hist: bool = True, lmin: str = "dxF",
                  nkeff_mask: float = 2e7) -> dict:
    """Reference Keff chain on one snapshot (tests/test_hist.py:16-101):
    the CPU oracle/baseline for the jitted keff_pipeline."""
    ctr = contours_linspace(tracer, N, increase)
    if hist:
        yc, tbl = area_table_hist(mask, ydef, dA, increase, lt)
        int_area = integral_within_contours_hist(tracer, ctr, dA, None, lt)
        int_grdS = integral_within_contours_hist(tracer, ctr, dA, grdS, lt)
    else:
        yc, tbl = area_table_broadcast(mask, ydef, dA, increase, lt)
        int_area = integral_within_contours(tracer, ctr, dA, None, lt)
        int_grdS = integral_within_contours(tracer, ctr, dA, grdS, lt)
    yeq = table_lookup_coordinates(tbl, yc, int_area)

    if lmin == "analytic":
        Lmin = latitude_lengths_at(yeq)
    elif lmin == "dxF":
        pre_lmin = np.sum(mask * dxF, axis=-1)
        Lmin = interp_to_coords(yeq, ydef, pre_lmin, ydef[-1] > ydef[0])
    elif lmin == "frac":
        lat_len = latitude_lengths_at(ydef)
        frac = np.sum(mask, axis=-1) / mask.shape[-1]
        Lmin = interp_to_coords(yeq, ydef, frac * lat_len, ydef[-1] > ydef[0])
    else:
        raise ValueError(lmin)

    dgrdSdA = gradient_wrt_area(int_grdS, int_area)
    dqdA = gradient_wrt_area(ctr, int_area)
    Leq2 = dgrdSdA / dqdA ** 2
    nkeff = Leq2 / Lmin / Lmin
    nkeff = np.where(nkeff < nkeff_mask, nkeff, np.nan)

    origin = dict(contour=ctr, intArea=int_area, Yeq=yeq, intgrdS=int_grdS,
                  dgrdSdA=dgrdSdA, dqdA=dqdA, Leq2=Leq2, Lmin=Lmin,
                  nkeff=nkeff, table=tbl, table_coords=yc)
    inc = yeq[0] < yeq[-1]
    interp = {k: interp_to_coords(pre_y, yeq, v, inc)
              for k, v in origin.items() if not k.startswith("table")}
    return dict(origin=origin, interp=interp)


def lwa_snapshot(tracer: np.ndarray, ydef: np.ndarray, dA: np.ndarray,
                 mask: np.ndarray, N: int = 121, increase: bool = True,
                 lt: bool = True, part: str = "all") -> dict:
    """Reference LWA chain on one snapshot (tests/test_LWA.py:48-87):
    hist table -> areas -> latEq -> sorted profile Q -> LWA + variant 2."""
    ctr = contours_linspace(tracer, N, increase)
    yc, tbl = area_table_hist(mask, ydef, dA, increase, lt)
    int_area = integral_within_contours_hist(tracer, ctr, dA, None, lt)
    yeq = table_lookup_coordinates(tbl, yc, int_area)
    Q = interp_to_coords(ydef, yeq, ctr, yeq[0] < yeq[-1])
    lwa = local_wave_activity(tracer, Q, dA, ydef, increase, part)
    lwa2 = local_wave_activity2(tracer, Q, dA, ydef, increase, part)
    return dict(contour=ctr, intArea=int_area, latEq=yeq, Q=Q,
                lwa=lwa, lwa2=lwa2)


def lwa_production_snapshot(q: np.ndarray, sigma: np.ndarray,
                            ydef: np.ndarray, dA: np.ndarray,
                            mask: np.ndarray, N: int, increase: bool = True,
                            lt: bool = True,
                            Rearth: float = _REARTH) -> dict:
    """σ-weighted (isentropic-density) production LWA, reference
    tests/LWA.py:46-88: the sorted tracer is the COMPOSITION σ·q, the area
    integral uses integrand 1 (``integrand=sigma*0+1`` in the reference),
    LWA is computed for σ·q against its own sorted profile, and ``lwa_norm``
    carries the reference's earth-circle-perimeter normalization
    lwa / (2πR·cos(lat)) (tests/LWA.py:22,80)."""
    out = lwa_snapshot(np.asarray(sigma, np.float64) * np.asarray(q, np.float64),
                       ydef, dA, mask, N=N, increase=increase, lt=lt)
    perim = latitude_lengths_at(np.asarray(ydef, np.float64), Rearth)
    out["lwa_norm"] = out["lwa"] / perim[:, None]
    return out


def squared_gradient(q: np.ndarray, ydef: np.ndarray, xdef: np.ndarray,
                     latlon: bool = True, periodic_x: bool = True,
                     Rearth: float = _REARTH) -> np.ndarray:
    """|grad q|^2 with centered differences; periodic X, extended Y.

    Stands in for the external GeoApps ``Dynamics.cal_squared_gradient`` /
    xinvert ``FiniteDiff.grad`` dependency the reference's scripts rely on
    (tests/test_Keff_atmos.py:51-55) — those packages are not in the reference
    repo, so these semantics (2nd-order centered, one-sided at walls) define
    the oracle.
    """
    q = np.asarray(q, np.float64)
    y = np.asarray(ydef, np.float64)
    x = np.asarray(xdef, np.float64)
    if latlon:
        d2r = np.pi / 180.0
        dy = np.gradient(y) * d2r * Rearth
        dxrow = np.gradient(x) * d2r * Rearth
        dx = np.cos(y * d2r)[:, None] * dxrow[None, :]
    else:
        dy = np.gradient(y)
        dx = np.broadcast_to(np.gradient(x)[None, :], q.shape).copy()

    if periodic_x:
        qx = (np.roll(q, -1, axis=-1) - np.roll(q, 1, axis=-1)) / (2.0 * dx)
    else:
        qx = np.gradient(q, axis=-1) / dx
    qy = np.gradient(q, axis=-2) / dy[:, None]
    return qx ** 2 + qy ** 2
