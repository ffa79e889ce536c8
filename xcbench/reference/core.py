"""Plain PyTorch reference of the contour-space chain's pieces.

Written from the definitions the chains state (xcontour's Keff, LWA and
contour-length diagnostics, and the port's documented edge rules), in any
floating dtype: the benchmark runs it in float64 to judge the program's
float32 outputs, and in bfloat16 as the control that must fail.  It imports
nothing of the program and reads nothing the program made: every table,
level and metric is worked out here from the raw inputs.

Conventions: fields (B, Ny, Nx) with the equivalent coordinate along axis
-2, ascending; contour-indexed values (B, N).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

R_EARTH = 6371200.0
D2R = math.pi / 180.0


# --------------------------------------------------------------- the grid
def _edges(c: np.ndarray) -> np.ndarray:
    e = np.empty(c.size + 1)
    e[1:-1] = 0.5 * (c[:-1] + c[1:])
    e[0] = c[0] - 0.5 * (c[1] - c[0])
    e[-1] = c[-1] + 0.5 * (c[-1] - c[-2])
    return e


def latlon_grid(lat, lon, dtype, device) -> dict:
    """Spherical cell areas R^2 |sin(phi_n) - sin(phi_s)| dlambda with the
    cell edges halfway between centres (pole-clamped), the coordinates in
    degrees, and whether longitude wraps around the globe."""
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    latE = np.clip(_edges(lat), -90.0, 90.0)
    dlam = np.diff(_edges(lon)) * D2R
    band = np.abs(np.diff(np.sin(latE * D2R)))
    area = R_EARTH ** 2 * band[:, None] * dlam[None, :]
    step = lon[1] - lon[0]
    periodic = abs((lon[-1] + step - 360.0 - lon[0]) / step) <= 1e-4

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64,
                               device=device).to(dtype)
    return dict(lat=t(lat), lon=t(lon), dA=t(area), periodic=periodic,
                reso=float(step))


# ------------------------------------------------------------ derivatives
def index_gradient(v: torch.Tensor) -> torch.Tensor:
    """Derivative along the last axis on a unit spacing: centred inside,
    one-sided at the ends."""
    return torch.cat([v[..., 1:2] - v[..., :1],
                      (v[..., 2:] - v[..., :-2]) / 2,
                      v[..., -1:] - v[..., -2:-1]], dim=-1)


def plane_gradient(q: torch.Tensor, g: dict):
    """(dq/dy, dq/dx) in metres: centred differences (periodic in x when
    the grid wraps, one-sided at the walls), dy = R dlat, dx = R cos(lat)
    dlon with the spacings' own centred differences."""
    lat, lon = g["lat"], g["lon"]
    dy = index_gradient(lat) * D2R * R_EARTH
    dx = torch.cos(lat * D2R)[:, None] * (index_gradient(lon) * D2R
                                          * R_EARTH)[None, :]
    if g["periodic"]:
        qx = (torch.roll(q, -1, -1) - torch.roll(q, 1, -1)) / 2
    else:
        qx = index_gradient(q)
    qy = index_gradient(q.transpose(-1, -2)).transpose(-1, -2)
    return qy / dy[:, None], qx / dx


# ------------------------------------------------------- levels and sums
def levels(q: torch.Tensor, N: int) -> torch.Tensor:
    """N equally spaced levels from each snapshot's smallest to its largest
    finite value, the last one the largest itself."""
    nan = torch.isnan(q)
    lo = torch.where(nan, torch.inf, q).amin(dim=(-2, -1))
    hi = torch.where(nan, -torch.inf, q).amax(dim=(-2, -1))
    k = torch.arange(N, dtype=q.dtype, device=q.device)
    out = lo[:, None] + (hi - lo)[:, None] / (N - 1) * k
    out[:, -1] = hi
    return out


def sums_below(q: torch.Tensor, lev: torch.Tensor, weights) -> list:
    """For each level L_k, the sum of each weight over the cells with
    q < L_k (q <= L_k at the last level, the top edge being inclusive);
    NaN cells and NaN weights add nothing.  By sorting each snapshot."""
    B = q.shape[0]
    v = q.reshape(B, -1)
    order = torch.argsort(torch.where(torch.isnan(v), torch.inf, v), dim=-1)
    vs = torch.gather(v, 1, order)
    vs = torch.where(torch.isnan(vs), torch.inf, vs).contiguous()
    pos = torch.searchsorted(vs, lev.contiguous(), side="left")
    pos[:, -1] = torch.searchsorted(vs, lev[:, -1:].contiguous(),
                                    side="right")[:, 0]
    out = []
    for w in weights:
        w = torch.broadcast_to(w, q.shape).reshape(B, -1)
        w = torch.where(torch.isnan(v) | torch.isnan(w), 0, w)
        cum = torch.cat([torch.zeros_like(w[:, :1]),
                         torch.cumsum(torch.gather(w, 1, order), -1)], -1)
        out.append(torch.gather(cum, 1, pos))
    return out


def area_table(g: dict) -> torch.Tensor:
    """A(y_j): the area of the rows strictly below row j, the whole area at
    the last row."""
    rows = g["dA"].sum(-1)
    tbl = torch.cumsum(rows, 0) - rows
    tbl[-1] = rows.sum()
    return tbl


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """np.interp along the last axis with batched tables (xp ascending):
    the interval is the one right of the last xp <= x, a zero-width one
    gives its right end, queries outside clamp to the end values, a NaN
    query gives NaN."""
    shape = torch.broadcast_shapes(x.shape[:-1], xp.shape[:-1],
                                   fp.shape[:-1])
    n = xp.shape[-1]
    xq = torch.broadcast_to(x, shape + x.shape[-1:]).contiguous()
    xp = torch.broadcast_to(xp, shape + (n,)).contiguous()
    fp = torch.broadcast_to(fp, shape + (n,))
    i = torch.searchsorted(xp, xq, right=True).clamp(1, n - 1)
    xl, xr = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    yl, yr = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    dx = xr - xl
    flat = dx == 0
    out = torch.where(flat, yr, yl + (xq - xl) / torch.where(flat, 1, dx)
                      * (yr - yl))
    out = torch.where(xq < xp[..., :1], fp[..., :1], out)
    out = torch.where(xq > xp[..., -1:], fp[..., -1:], out)
    return torch.where(torch.isnan(xq), torch.nan, out)


def equivalent_latitude(area: torch.Tensor, g: dict) -> torch.Tensor:
    """Y_eq: the latitude whose polar cap south of it holds ``area``, by
    the grid's own A(y) table."""
    return interp(area, area_table(g), g["lat"])


def keff_terms(ctr, area, grad_integral, Lmin, mask: float) -> dict:
    """d/dA of the |grad q|^2 integral and of the levels, the squared
    equivalent length Leq^2 = (d int |grad q|^2 dA / dA) / (dq/dA)^2 and
    the normalised Keff Leq^2 / Lmin^2, NaN from ``mask`` up (also given
    unmasked as ``nkeff_raw``)."""
    dA = index_gradient(area)
    dgrdSdA = index_gradient(grad_integral) / dA
    dqdA = index_gradient(ctr) / dA
    Leq2 = dgrdSdA / (dqdA * dqdA)
    raw = Leq2 / Lmin / Lmin
    return dict(dgrdSdA=dgrdSdA, dqdA=dqdA, Leq2=Leq2, nkeff_raw=raw,
                nkeff=torch.where(raw < mask, raw, torch.nan))


def profile(g: dict, Yeq: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """The sorted profile Q(y): the levels placed at their equivalent
    latitudes, read at the grid's latitudes."""
    return interp(g["lat"], Yeq, ctr)


# ------------------------------------------------------------ wave activity
def wave_activity(q: torch.Tensor, Q: torch.Tensor, dA: torch.Tensor,
                  chunk: int = 8) -> torch.Tensor:
    """Local finite-amplitude wave activity (Huang and Nakamura 2016) for a
    tracer increasing with y, with xcontour's weight W = dA * dA / max(dA):

        LWA(j, x) = sum over y < y_j of  (q - Q_j) W  where q > Q_j
                  + sum over y >= y_j of (Q_j - q) W  where q < Q_j,

    pair by pair, ``chunk`` surfaces j at a time.  NaN cells and NaN
    profile values add nothing."""
    W = dA / dA.max() * dA
    Ny = q.shape[-2]
    iy = torch.arange(Ny, device=q.device)
    rows = []
    for j0 in range(0, Ny, chunk):
        js = torch.arange(j0, min(Ny, j0 + chunk), device=q.device)
        qe = q[:, None] - Q[:, js, None, None]            # (B, c, Ny, Nx)
        below = (iy[None, :] < js[:, None])[None, :, :, None]
        term = torch.where(below, qe.clamp(min=0), -qe.clamp(max=0))
        rows.append(torch.nan_to_num(term * W, nan=0.0).sum(2))
    return torch.cat(rows, dim=1)


# --------------------------------------------------------- contour lengths
def _haversine(y0, x0, y1, x1):
    a = (torch.sin((y1 - y0) / 2) ** 2
         + torch.cos(y0) * torch.cos(y1) * torch.sin((x1 - x0) / 2) ** 2)
    return 2 * torch.arcsin(torch.sqrt(a.clamp(0, 1)))


def contour_lengths(q: torch.Tensor, lev: torch.Tensor, y: torch.Tensor,
                    x: torch.Tensor, latlon: bool) -> torch.Tensor:
    """Total length of each level's contour by marching squares: each cell
    whose corners straddle a level (min <= L < max, no NaN corner) holds a
    segment between the crossing points of its edges, found by linear
    interpolation; a saddle (diagonal corners above) joins the top edge to
    the left and the bottom to the right when the corner (0, 0) is above,
    else the top to the right and the bottom to the left ('low'
    connectivity).  No cell wraps around in x.  Great-circle lengths on a
    sphere of radius R_EARTH (y, x in degrees) or plane lengths; a level
    with no length gives NaN."""
    if latlon:
        y, x = y * D2R, x * D2R
    B, Ny, Nx = q.shape
    N = lev.shape[-1]
    c = [q[:, :-1, :-1], q[:, :-1, 1:], q[:, 1:, :-1], q[:, 1:, 1:]]
    cs = torch.stack(c)
    bad = torch.isnan(cs).any(0)
    lo = torch.where(bad, torch.inf, cs.amin(0)).reshape(B, -1)
    hi = torch.where(bad, -torch.inf, cs.amax(0)).reshape(B, -1)
    totals = torch.zeros((B, N), dtype=q.dtype, device=q.device)
    for b in range(B):
        srt, idx = torch.sort(lev[b])
        start = torch.searchsorted(srt, lo[b].contiguous())
        count = (torch.searchsorted(srt, hi[b].contiguous()) - start).clamp(
            min=0)
        cell = torch.repeat_interleave(torch.arange(count.numel(),
                                                    device=q.device), count)
        if cell.numel() == 0:
            continue
        first = torch.cumsum(count, 0) - count
        k = idx[start[cell] + torch.arange(cell.numel(), device=q.device)
                - first[cell]]
        L = lev[b, k]
        i, j = cell // (Nx - 1), cell % (Nx - 1)
        v00, v01 = q[b, i, j], q[b, i, j + 1]
        v10, v11 = q[b, i + 1, j], q[b, i + 1, j + 1]
        y0, y1, x0, x1 = y[i], y[i + 1], x[j], x[j + 1]

        def cut(va, vb):
            d = vb - va
            return torch.where(d == 0, 0, (L - va) / torch.where(d == 0, 1, d))

        def mix(f, c0, c1):
            return (1 - f) * c0 + f * c1
        pts = {"top": (y0, mix(cut(v00, v01), x0, x1)),
               "bot": (y1, mix(cut(v10, v11), x0, x1)),
               "lef": (mix(cut(v00, v10), y0, y1), x0),
               "rig": (mix(cut(v01, v11), y0, y1), x1)}

        def seg(p, r):
            (ya, xa), (yb, xb) = pts[p], pts[r]
            if latlon:
                return _haversine(ya, xa, yb, xb)
            return torch.hypot(yb - ya, xb - xa)
        a00, a01, a10, a11 = (v > L for v in (v00, v01, v10, v11))
        code = (a00.long() * 8 + a01.long() * 4 + a10.long() * 2
                + a11.long())
        # the edges a segment joins, by which corners lie above the level
        table = {0b1000: ("top", "lef"), 0b0111: ("top", "lef"),
                 0b0100: ("top", "rig"), 0b1011: ("top", "rig"),
                 0b0010: ("bot", "lef"), 0b1101: ("bot", "lef"),
                 0b0001: ("bot", "rig"), 0b1110: ("bot", "rig"),
                 0b1100: ("lef", "rig"), 0b0011: ("lef", "rig"),
                 0b1010: ("top", "bot"), 0b0101: ("top", "bot"),
                 0b1001: ("top", "lef"), 0b0110: ("top", "rig")}
        seg_len = torch.zeros_like(L)
        for kcode, (p, r) in table.items():
            seg_len = torch.where(code == kcode, seg(p, r), seg_len)
        seg_len = seg_len + torch.where(code == 0b1001, seg("bot", "rig"), 0)
        seg_len = seg_len + torch.where(code == 0b0110, seg("bot", "lef"), 0)
        totals[b].index_add_(0, k, seg_len)
    scale = R_EARTH if latlon else 1.0
    return torch.where(totals == 0, torch.nan, totals * scale)


# --------------------------------------------------------------- fractal
def block_mean(q: torch.Tensor, s: int) -> torch.Tensor:
    """The mean of each s x s block's finite values (NaN for none)."""
    if s == 1:
        return q
    B, Ny, Nx = q.shape
    blk = q.reshape(B, Ny // s, s, Nx // s, s)
    n = (~torch.isnan(blk)).sum(dim=(2, 4))
    tot = torch.nan_to_num(blk, nan=0.0).sum(dim=(2, 4))
    return torch.where(n > 0, tot / n.clamp(min=1), torch.nan)


def box_lengths(q: torch.Tensor, lev: torch.Tensor, dA: torch.Tensor,
                strides, chunk: int = 16) -> torch.Tensor:
    """Box-counting lengths (B, N, S): x padded once by the largest stride
    with its last column, boxes of (s + 1) x (s + 1) points advancing by s
    (all full row boxes but the last, as many column boxes as the padded
    width gives boxes less one), and each box whose finite values straddle
    a level (min <= L < max) adds sqrt(dA at its corner) * s."""
    pad = max(strides)
    qp = torch.cat([q, q[..., -1:].expand(*q.shape[:-1], pad)], -1)
    ap = torch.cat([dA, dA[:, -1:].expand(dA.shape[0], pad)], -1)
    nan = torch.isnan(qp)[:, None]
    out = []
    for s in strides:
        Jn = round(qp.shape[-2] / s)
        In = round(qp.shape[-1] / s)
        hi = F.max_pool2d(torch.where(nan, -torch.inf, qp[:, None]), s + 1, s)
        lo = -F.max_pool2d(torch.where(nan, -torch.inf, -qp[:, None]), s + 1,
                           s)
        hi, lo = hi[:, 0, :Jn - 1, :In - 1], lo[:, 0, :Jn - 1, :In - 1]
        w = torch.nan_to_num(torch.sqrt(ap[::s, ::s][:Jn - 1, :In - 1]) * s,
                             nan=0.0)
        tot = []
        for k in range(0, lev.shape[-1], chunk):
            L = lev[:, k:k + chunk, None, None]
            hit = (lo[:, None] <= L) & (hi[:, None] > L)
            tot.append(torch.where(hit, w, 0).sum(dim=(-2, -1)))
        out.append(torch.cat(tot, -1))
    return torch.stack(out, -1)


def loglog_dimension(lengths: torch.Tensor, rulers: torch.Tensor):
    """The least-squares slope of log(L / r) against -log(r) over the
    finite pairs of each row; NaN for fewer than two."""
    X = -torch.log(rulers)
    Y = torch.log(lengths / rulers)
    ok = torch.isfinite(X) & torch.isfinite(Y)
    n = ok.sum(-1)
    X, Y = torch.where(ok, X, 0), torch.where(ok, Y, 0)
    sx, sy = X.sum(-1), Y.sum(-1)
    den = n * (X * X).sum(-1) - sx * sx
    slope = (n * (X * Y).sum(-1) - sx * sy) / torch.where(den == 0, 1, den)
    return torch.where((n >= 2) & (den != 0), slope, torch.nan)
