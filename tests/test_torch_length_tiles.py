"""The decompositions of K7 and K8 (``xcontour_tpu_torch/csrc/length.cu``),
emulated on the CPU.

The CUDA kernels run only on the card, but the way they cut the work can be
checked here, in float64 with the kernels' own formulas (vertices as
offsets from a cell's corner, one edge fraction an endpoint, the segment
table ``kSegTable`` read from the sources).

K7: tiles of ``kernels.length.TILE`` cells, each thread's 8 cells of one
column; the tile's range [n0, n1) of sorted levels; chunks of
``kLevelChunk`` levels; each cell's crossed levels [a, a + m) by search;
the queue of (cell, level) pairs in slot order (threads in order, a cell's
levels ascending) measured in rounds of ``kQueue``; 64-bit fixed-point
totals at the coordinates' scale, integer sums in any order.

K8: a warp per slab of ``kSlabSteps`` steps of a block of stride x stride
cells on the windows' lattice (its first min(stride, window - 1) rows and
columns), its cells' corner ranges in registers; the windows covering the
block tested against the range of kCellSteps steps of cells, then those cells classified
against each active window's level, clipped to the window; 64-bit
fixed-point window totals at the field's scale.

Tolerance: the emulations differ from the plain versions (run in float64)
only in summation order, in vertices taken as offsets rather than convex
combinations, and in fixed-point quanta (at most 2^-40 of the largest
cell extent at these sizes), so they must agree to 1e-12 of the plain output's largest value,
with the same exact zeros.
"""

import math
import re

import numpy as np
import pytest
import torch

import xcontour_tpu_torch as xt
from xcontour_tpu_torch.kernels import _build
from xcontour_tpu_torch.kernels import length as kl
from xcontour_tpu_torch.utils.synth import synth_pv

F64_RTOL = 1e-12
THREADS = 256
# K7's tile constants and the segment table sit in length.cuh (shared with
# the probe P3), K8's in length.cu
_SRC = "".join((_build.CSRC_DIR / f).read_text()
               for f in ("length.cuh", "length.cu"))


def _const(name):
    return int(re.search(rf"{name} = (0x[0-9a-fA-F]+|\d+)", _SRC).group(1), 0)


SEG_TABLE = _const("kSegTable")
LEVEL_CHUNK = _const("kLevelChunk")
QUEUE = _const("kQueue")
CELL_STEPS = _const("kCellSteps")
SLAB_STEPS = _const("kSlabSteps")
ROWS = kl.TILE[0] * kl.TILE[1] // THREADS


def _edge_point(edge, lev, v00, v01, v10, v11, dy, dx):
    """length.cu's edge_point: top (0, f dx), bottom (dy, f dx), left
    (f dy, 0), right (f dy, dx)."""
    va = np.where(edge == 1, v10, np.where(edge == 3, v01, v00))
    vb = np.where(edge == 0, v01, np.where(edge == 2, v10, v11))
    d = vb - va
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(d == 0, 0.0, (lev - va) / np.where(d == 0, 1.0, d))
    py = np.where(edge < 2, np.where(edge == 1, dy, 0.0), f * dy)
    px = np.where(edge < 2, f * dx, np.where(edge == 3, dx, 0.0))
    return py, px


def _seg_len(p, q, y0, latlon):
    dy, dx = p[0] - q[0], p[1] - q[1]
    if not latlon:
        return np.hypot(dy, dx)
    a = (np.sin(0.5 * dy) ** 2
         + np.cos(y0 + p[0]) * np.cos(y0 + q[0]) * np.sin(0.5 * dx) ** 2)
    return 2.0 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def _code(lev, v00, v01, v10, v11):
    return ((v00 > lev).astype(np.int64) | (v01 > lev) << 1
            | (v10 > lev) << 2 | (v11 > lev) << 3)


def _crossing_length(lev, v00, v01, v10, v11, y0, dy, dx, latlon):
    """length.cu's crossing_length over arrays of crossed cells."""
    code = _code(lev, v00, v01, v10, v11)
    assert ((code > 0) & (code < 15)).all()
    seg = ((np.uint64(SEG_TABLE) >> (4 * code).astype(np.uint64))
           & np.uint64(15)).astype(np.int64)
    pts = lambda e: _edge_point(e, lev, v00, v01, v10, v11, dy, dx)
    L = _seg_len(pts(seg & 3), pts(seg >> 2), y0, latlon)
    sad = (code == 6) | (code == 9)
    L2 = _seg_len(pts(np.ones_like(code)), pts(np.where(code == 9, 3, 2)),
                  y0, latlon)
    return L + np.where(sad, L2, 0.0)


def _corner_ranges(sv):
    """[lo, hi) of each cell of a corner array; (inf, -inf) with a NaN."""
    c = np.stack([sv[..., :-1, :-1], sv[..., :-1, 1:], sv[..., 1:, :-1],
                  sv[..., 1:, 1:]])
    bad = np.isnan(c).any(0)
    with np.errstate(invalid="ignore"):
        lo, hi = c.min(0), c.max(0)
    return np.where(bad, np.inf, lo), np.where(bad, -np.inf, hi)


def _warp_tree(vals):
    """lane 0 of s += __shfl_down_sync(s, o) for o = 16, 8, 4, 2, 1."""
    v = np.array(vals, dtype=np.float64)
    for o in (16, 8, 4, 2, 1):
        v[:o] = v[:o] + v[o:2 * o]
    return v[0]


def _scale(yc, xc, count):
    """The kernels' fixed-point scale: bits for totals over ``count`` cells
    less the exponent of the largest row plus column spacing (float32)."""
    dyv, dxv = np.abs(np.diff(yc, axis=-1)), np.abs(np.diff(xc, axis=-1))
    ext = float(np.float32(dyv[np.isfinite(dyv)].max(initial=0.0))
                + np.float32(dxv[np.isfinite(dxv)].max(initial=0.0)))
    lg = 0
    while 2 ** lg < 2 * count:
        lg += 1
    return 62 - lg - math.frexp(ext)[1]


def _k7_emulate(data, levels, yc, xc, latlon, stats=None):
    """K7 as the kernel cuts it (float64): returns the (B, N) totals."""
    B, Ny, Nx = data.shape
    N = levels.shape[1]
    RB, CB = kl.TILE
    assert RB * CB == THREADS * ROWS
    order = np.argsort(levels, axis=1, kind="stable")        # NaN last
    srt = np.take_along_axis(levels, order, 1)
    n_rb, n_cb = -(-(Ny - 1) // RB), -(-(Nx - 1) // CB)
    scale = _scale(yc, xc, (Ny - 1) * (Nx - 1))
    acc = np.zeros((B, N), np.uint64)
    # the cells in thread order: thread t owns column t % CB, rows
    # (t // CB) * ROWS + i
    t = np.arange(THREADS)
    R = ((t // CB) * ROWS)[:, None] + np.arange(ROWS)[None]
    C = np.broadcast_to((t % CB)[:, None], R.shape)
    R, C = R.ravel(), C.ravel()
    st = stats if stats is not None else {}
    st.setdefault("rounds", 0)
    st.setdefault("chunks", 0)
    for b in range(B):
        yb = yc[b] if yc.ndim == 2 else yc
        xb = xc[b] if xc.ndim == 2 else xc
        for tile in range(n_rb * n_cb):
            row0, col0 = (tile // n_cb) * RB, (tile % n_cb) * CB
            sv = np.full((RB + 1, CB + 1), np.nan)
            blk = data[b, row0:row0 + RB + 1, col0:col0 + CB + 1]
            sv[:blk.shape[0], :blk.shape[1]] = blk
            sy = np.zeros(RB + 1)
            sx = np.zeros(CB + 1)
            ys, xs = yb[row0:row0 + RB + 1], xb[col0:col0 + CB + 1]
            sy[:len(ys)], sx[:len(xs)] = ys, xs
            lo_all, hi_all = _corner_ranges(sv)
            lo, hi = lo_all[R, C], hi_all[R, C]
            n0 = int(np.searchsorted(srt[b], lo.min(), side="left"))
            n1 = max(n0, int(np.searchsorted(srt[b], hi.max(), side="left")))
            for base in range(n0, n1, LEVEL_CHUNK):
                st["chunks"] += 1
                cnt = min(LEVEL_CHUNK, n1 - base)
                slev = srt[b, base:base + cnt]
                ok = lo <= hi
                a = np.where(ok, np.searchsorted(slev, lo, side="left"), 0)
                m = np.where(ok, np.searchsorted(slev, hi, side="left") - a, 0)
                cell = np.repeat(np.arange(len(R)), m)
                lev_i = np.repeat(a, m) + (np.arange(m.sum())
                                          - np.repeat(np.cumsum(m) - m, m))
                for q0 in range(0, len(cell), QUEUE):
                    st["rounds"] += 1
                    cq, kq = cell[q0:q0 + QUEUE], lev_i[q0:q0 + QUEUE]
                    r, c = R[cq], C[cq]
                    lev = slev[kq]
                    L = _crossing_length(lev, sv[r, c], sv[r, c + 1],
                                         sv[r + 1, c], sv[r + 1, c + 1],
                                         sy[r], sy[r + 1] - sy[r],
                                         sx[c + 1] - sx[c], latlon)
                    assert np.isfinite(L).all()
                    fixed = np.ceil(np.ldexp(L, scale))
                    # integer sums: any order (the kernel's lane copies,
                    # tiles in any order) gives the same totals
                    np.add.at(acc[b], base + kq, fixed.astype(np.uint64))
    assert (acc < np.uint64(2 ** 62)).all()
    out_s = np.ldexp(acc.astype(np.float64), -scale)
    out = np.empty_like(out_s)
    np.put_along_axis(out, order, out_s, 1)
    return out


def _lane_map(w):
    cw = min(w, 32)
    return cw, 32 // cw


def _k8_emulate(data, levels, yc, xc, window, stride, latlon, pretest=True,
                stats=None):
    """K8 as the kernel cuts it (float64): returns the (Wy, Wx) totals."""
    Ny, Nx = data.shape
    Wy, Wx = levels.shape
    s, cells = stride, window - 1
    if cells < 1:
        return np.zeros((Wy, Wx))
    nby, nbx, nbw = kl.lattice(Wy, Wx, window, stride)
    lo, hi = _corner_ranges(data)                       # (Ny - 1, Nx - 1)
    scale = _scale(yc, xc, cells * cells)
    acc = np.zeros((Wy, Wx), np.uint64)
    bs = min(s, cells)          # a block's cells a side that windows cover
    ccw, crps = _lane_map(bs)
    lanes = np.arange(32)
    lr, lc = lanes // ccw, lanes % ccw
    st = stats if stats is not None else {}
    st.setdefault("classified", 0)
    st.setdefault("crossed", 0)
    for bi in range(nby):
        for bj in range(nbx):
            r0, c0 = bi * s, bj * s
            h, wd = min(bs, Ny - 1 - r0), min(bs, Nx - 1 - c0)
            assert h > 0 and wd > 0
            nc = -(-wd // ccw)
            steps = -(-h // crps) * nc
            wy0, wx0 = max(0, bi - nbw + 1), max(0, bj - nbw + 1)
            nwy, nwx = min(Wy - 1, bi) - wy0 + 1, min(Wx - 1, bj) - wx0 + 1
            # each warp's slab of SLAB_STEPS steps, in its own groups
            groups = [(g, min(g + CELL_STEPS, g0 + SLAB_STEPS, steps))
                      for g0 in range(0, steps, SLAB_STEPS)
                      for g in range(g0, min(g0 + SLAB_STEPS, steps),
                                     CELL_STEPS)]
            for g, g_end in groups:
                # the group's cells in step then lane order, from the block's
                # corner; (inf, -inf) outside the block or with a NaN corner
                t = np.arange(g, g_end)[:, None]
                rr = (t // nc) * crps + lr[None]
                cc = (t % nc) * ccw + lc[None]
                ok = (lr[None] < crps) & (rr < h) & (cc < wd)
                rr, cc = rr[ok], cc[ok]
                glo = lo[r0 + rr, c0 + cc]
                ghi = hi[r0 + rr, c0 + cc]
                if not glo.min(initial=np.inf) < ghi.max(initial=-np.inf):
                    continue
                for k in range(nwy * nwx):             # windows in lane order
                    wy, wx = wy0 + k // nwx, wx0 + k % nwx
                    lev = levels[wy, wx]
                    if not (glo.min() <= lev < ghi.max()) and (
                            pretest or np.isnan(lev)):
                        continue
                    ry, rx = wy * s - r0, wx * s - c0
                    st["classified"] += int((glo <= ghi).sum())
                    hit = ((glo <= lev) & (lev < ghi) & (rr >= ry)
                           & (rr < ry + cells) & (cc >= rx) & (cc < rx + cells))
                    if not hit.any():
                        continue
                    r, c = r0 + rr[hit], c0 + cc[hit]
                    st["crossed"] += len(r)
                    L = _crossing_length(lev, data[r, c], data[r, c + 1],
                                         data[r + 1, c], data[r + 1, c + 1],
                                         yc[r], yc[r + 1] - yc[r],
                                         xc[c + 1] - xc[c], latlon)
                    fixed = np.ceil(np.ldexp(L, scale))
                    assert np.isfinite(L).all()
                    acc[wy, wx] += fixed.astype(np.uint64).sum()
    assert (acc < np.uint64(2 ** 62)).all()
    out = np.ldexp(acc.astype(np.float64), -scale)
    return np.where(np.isnan(levels), 0.0, out)


def _agree(got, want, rtol=F64_RTOL):
    assert got.shape == want.shape
    assert np.array_equal(got == 0, want == 0)
    assert not np.isnan(got).any()
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _pv(B, nlat, nlon, seed, nan_patch=True):
    # synth_pv scales its levels by their spread: at least two levels
    v, _ = synth_pv(nlev=max(B, 2), nlat=nlat, nlon=nlon, seed=seed)
    pv = v["pv"][-B:].astype(np.float64)
    if nan_patch:
        pv[0, nlat // 3:nlat // 3 + 4, nlon // 5:nlon // 5 + 9] = np.nan
    return (np.deg2rad(v["latitude"]).astype(np.float64),
            np.deg2rad(v["longitude"]).astype(np.float64), pv)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _k7_plain(d, lev, y, x, latlon):
    return kl.contour_lengths_plain(_t(d), _t(lev), _t(y), _t(x),
                                    latlon=latlon, chunk=64).numpy()


def _k8_plain(d, lev, y, x, window, stride, latlon):
    return kl.local_lengths_plain(_t(d), _t(lev), _t(y), _t(x), window=window,
                                  stride=stride, latlon=latlon).numpy()


def _k7_case(kind):
    """(data (B, Ny, Nx), levels (B, N), yc, xc, latlon)."""
    rng = np.random.default_rng(3)
    if kind == "banded_latlon":
        y, x, d = _pv(2, 40, 300, 1)                   # 3 x 3 tiles
        lev = xt.cal_contours(_t(d), 21).numpy()
        return d, lev, y, x, True
    if kind == "noise_cartesian":
        d = rng.standard_normal((2, 23, 140))
        lev = rng.standard_normal((2, 15)) * 1.5      # unsorted
        lev[0, 3] = lev[0, 7]                          # a duplicate
        lev[1, [2, 9]] = np.nan
        return d, lev, np.arange(23) * 1e4, np.arange(140) * 1e4, False
    if kind == "per_batch_coords":
        y, x, d = _pv(3, 20, 150, 2, nan_patch=False)
        lev = xt.cal_contours(_t(d), 9).numpy()
        yb = y[None] + 0.01 * np.arange(3)[:, None]
        xb = x[None] * (1.0 + 0.1 * np.arange(3)[:, None])
        return d, lev, yb, xb, True
    if kind == "many_levels":
        # 2600 levels: three chunks, and more crossed pairs than a round
        d = rng.standard_normal((1, 20, 140)).cumsum(1)
        lo, hi = np.nanmin(d), np.nanmax(d)
        lev = np.linspace(lo, hi, 2600)[None]
        return d, lev, np.linspace(-0.5, 0.5, 20), np.linspace(0, 2, 140), True
    if kind == "nan_field":
        d = rng.standard_normal((2, 18, 30))
        d[0] = np.nan                                  # no valid cell
        d[1, ::2, ::3] = np.nan
        lev = rng.standard_normal((2, 6))
        return d, lev, np.linspace(0, 1, 18), np.linspace(0, 1, 30), True
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["banded_latlon", "noise_cartesian",
                                  "per_batch_coords", "many_levels",
                                  "nan_field"])
def test_k7_emulation_matches_plain(kind):
    d, lev, y, x, latlon = _k7_case(kind)
    stats = {}
    got = _k7_emulate(d, lev, y, x, latlon, stats)
    _agree(got, _k7_plain(d, lev, y, x, latlon))
    if kind == "many_levels":
        assert stats["chunks"] >= 3 and stats["rounds"] > stats["chunks"]


@pytest.mark.parametrize("latlon", [True, False])
def test_k7_seed7_min_and_max_levels_total_exactly_zero(latlon):
    """The exact-empty rule through the decomposition: 64 of the seed-7
    fields at [min, mid, max] give exact zeros at min and max."""
    rng = np.random.default_rng(7)
    d = rng.normal(size=(256, 12, 14)) * rng.uniform(0.1, 1000.0, (256, 1, 1)) \
        + rng.uniform(-50.0, 50.0, (256, 1, 1))
    d = d[:64]
    lo, hi = d.min(axis=(1, 2)), d.max(axis=(1, 2))
    lev = np.stack([lo, 0.5 * (lo + hi), hi], axis=1)
    if latlon:
        y, x = np.deg2rad(np.linspace(-60, 60, 12)), np.deg2rad(np.linspace(0, 348, 14))
    else:
        y, x = np.linspace(0, 1900, 12), np.linspace(0, 2900, 14)
    got = _k7_emulate(d, lev, y, x, latlon)
    assert (got[:, 0] == 0).all() and (got[:, 2] == 0).all()
    assert (got[:, 1] > 0).all()
    _agree(got, _k7_plain(d, lev, y, x, latlon))


def test_k7_pairs_are_exactly_the_crossed_cells():
    """A cell's levels in [min, max) of its corners are the levels whose
    marching-squares code is neither 0 nor 15: the queue holds every
    crossed pair and nothing else."""
    rng = np.random.default_rng(8)
    v = rng.standard_normal((5000, 4)).round(1)       # ties on purpose
    lev = np.linspace(-3, 3, 61)
    code = _code(lev[None], *(v[:, k:k + 1] for k in range(4)))
    crossed = (code > 0) & (code < 15)
    lo, hi = v.min(1, keepdims=True), v.max(1, keepdims=True)
    assert np.array_equal(crossed, (lo <= lev[None]) & (lev[None] < hi))


def test_k7_segment_fits_the_scale():
    """Each segment is at most the largest row plus column spacing (the
    fixed-point scale's premise), on the sphere for cells up to a quarter
    turn wide and in the plane."""
    rng = np.random.default_rng(9)
    n = 20000
    v = rng.standard_normal((n, 4))
    lev = rng.uniform(v.min(1), v.max(1))
    y0 = rng.uniform(-1.5, 1.4, n)
    dy = rng.uniform(1e-4, 0.1, n)
    dx = rng.uniform(1e-4, np.pi / 2, n)
    ok = _code(lev, *v.T)
    keep = (ok > 0) & (ok < 15)
    for latlon in (True, False):
        L = _crossing_length(lev[keep], *(v[keep, k] for k in range(4)),
                             y0[keep], dy[keep], dx[keep], latlon)
        # a saddle's two segments each fit; one segment at most dy + dx
        assert (L <= 2 * (dy[keep] + dx[keep]) * (1 + 1e-12)).all()
        sad = np.isin(ok[keep], (6, 9))
        assert (L[~sad] <= (dy[keep] + dx[keep])[~sad] * (1 + 1e-12)).all()


def _k8_case(kind):
    """(data (Ny, Nx), levels (Wy, Wx), yc, xc, window, stride, latlon)."""
    rng = np.random.default_rng(4)
    if kind == "w101_s10":
        y, x, d = _pv(1, 121, 240, 5)
        d = d[0]
        window, stride = 101, 10
        lev = xt.rolling_mean(_t(d), window, stride)[0].numpy()
        return d, lev, y, x, window, stride, True
    if kind == "w12_s5":
        y, x, d = _pv(1, 60, 80, 6)
        d = d[0]
        lev = xt.rolling_mean(_t(d), 12, 5)[0].numpy()
        return d, lev, y, x, 12, 5, True
    if kind == "w81_s40":
        # a stride past a warp's 32 lanes: several column steps a block
        y, x, d = _pv(1, 130, 250, 9)
        d = d[0]
        lev = xt.rolling_mean(_t(d), 81, 40)[0].numpy()
        return d, lev, y, x, 81, 40, True
    if kind == "stride_over_window":
        y, x, d = _pv(1, 50, 70, 7)
        d = d[0]
        lev = xt.rolling_mean(_t(d), 6, 9)[0].numpy()
        return d, lev, y, x, 6, 9, True
    if kind == "nan_patches_levels":
        y, x, d = _pv(1, 64, 90, 8)
        d = d[0]
        d[40:44, 10:30] = np.nan
        lev = xt.rolling_mean(_t(d), 16, 6)[0].numpy()
        lev[1, 3] = np.nan
        lev[4, :5] = np.nan
        return d, lev, y, x, 16, 6, True
    if kind == "noise_cartesian":
        d = rng.standard_normal((40, 50))
        lev = xt.rolling_mean(_t(d), 9, 3)[0].numpy()
        return d, lev, np.arange(40) * 1e4, np.arange(50) * 2e4, 9, 3, False
    if kind == "single_cells":
        d = rng.standard_normal((30, 8)).cumsum(0)
        lev = xt.rolling_mean(_t(d), 2, 1)[0].numpy()
        return d, lev, np.linspace(-1, 1, 30), np.linspace(0, 0.1, 8), 2, 1, True
    if kind == "window_one":
        d = rng.standard_normal((10, 12))
        return d, d[::2, ::2].copy(), np.linspace(0, 1, 10), np.linspace(0, 1, 12), 1, 2, True
    raise ValueError(kind)


K8_KINDS = ["w101_s10", "w12_s5", "w81_s40", "stride_over_window",
            "nan_patches_levels", "noise_cartesian", "single_cells",
            "window_one"]


@pytest.mark.parametrize("kind", K8_KINDS)
def test_k8_emulation_matches_plain(kind):
    d, lev, y, x, window, stride, latlon = _k8_case(kind)
    stats = {}
    got = _k8_emulate(d, lev, y, x, window, stride, latlon, stats=stats)
    _agree(got, _k8_plain(d, lev, y, x, window, stride, latlon))
    assert (got[np.isnan(lev)] == 0).all()
    if kind == "w101_s10":
        # the pretest leaves well under half of the windows' cells
        assert stats["classified"] < 0.5 * lev.size * (window - 1) ** 2
    if kind == "w12_s5":
        # all integer sums: the same totals in any order of the crossings
        assert stats["crossed"] > 0


@pytest.mark.parametrize("kind", ["w12_s5", "stride_over_window",
                                  "nan_patches_levels", "noise_cartesian"])
def test_k8_pretest_skips_no_crossed_cell(kind):
    """With the block pretest and without it the queues hold the same
    crossings in the same order: the same bits."""
    d, lev, y, x, window, stride, latlon = _k8_case(kind)
    on, off = {}, {}
    a = _k8_emulate(d, lev, y, x, window, stride, latlon, True, on)
    b = _k8_emulate(d, lev, y, x, window, stride, latlon, False, off)
    assert np.array_equal(a, b)
    assert on["crossed"] == off["crossed"] > 0
    assert on["classified"] <= off["classified"]
    if kind in ("w12_s5", "nan_patches_levels"):
        # banded fields: blocks away from a window's contour are skipped (a
        # window of noise, or one window a block, crosses every block)
        assert on["classified"] < off["classified"]


def test_k8_window_minimum_totals_exactly_zero():
    """64 windows of 9 x 9 cells at their own minimum (the chip check's
    case) give exact zeros."""
    rng = np.random.default_rng(7)
    f = rng.normal(size=(80, 80)) * rng.uniform(0.1, 1000.0) \
        + rng.uniform(-50.0, 50.0)
    wmin = f.reshape(8, 10, 8, 10).min(axis=(1, 3))
    y, x = np.deg2rad(np.linspace(-60, 60, 80)), np.deg2rad(np.linspace(0, 300, 80))
    got = _k8_emulate(f, wmin, y, x, 10, 10, True)
    assert (got == 0).all()
    _agree(got, _k8_plain(f, wmin, y, x, 10, 10, True))


@pytest.mark.parametrize("window,stride,Ny,Nx", [(101, 10, 721, 1440),
                                                 (101, 7, 721, 1440),
                                                 (64, 10, 721, 1440),
                                                 (101, 40, 721, 1440),
                                                 (161, 80, 721, 1440),
                                                 (31, 45, 721, 1440),
                                                 (2, 1, 65600, 8),
                                                 (6, 9, 50, 70)])
def test_k8_lattice_covers_every_window(window, stride, Ny, Nx):
    """The lattice holds every block a window covers, and every block has
    at least one cell of the field: windows of window - 1 cells a side
    starting on block boundaries."""
    Wy = len(range(0, Ny - window + 1, stride))
    Wx = len(range(0, Nx - window + 1, stride))
    nby, nbx, nbw = kl.lattice(Wy, Wx, window, stride)
    cells = window - 1
    assert (nbw - 1) * stride < cells <= nbw * stride
    assert Wy - 1 + nbw == nby and Wx - 1 + nbw == nbx
    # the last block's first cell lies inside the field
    assert (nby - 1) * stride < Ny - 1 and (nbx - 1) * stride < Nx - 1
    if (window, stride) == (101, 10):
        assert (nby, nbx, nbw) == (72, 143, 10)
