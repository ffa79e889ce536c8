"""Windowed local contour lengths (xcontour's local length,
tests/test_localLength.py): for each window of ``window`` x ``window``
points anchored every ``stride`` points (the last anchor the last that
fits; no wrap in x), the mean of its finite points (NaN for fewer than
``min_count``), and the length of the contour inside the window at that
mean, by ``core.contour_lengths``' marching-squares rules in the window's
own coordinates: a cell of the window whose corners straddle the level
(min <= L < max, no NaN corner) holds a segment between its edges'
crossing points, 'low' saddles, great-circle metres.  A window with no
length gives NaN.

The means are summed directly over each window's points; the crossed
(window, cell) pairs are found from each cell's corner range and measured
alone, a field and a chunk of ``rows`` window rows at a time."""

from __future__ import annotations

import torch

from xcbench.reference import core


def _anchors(n: int, window: int, stride: int) -> int:
    return len(range(0, n - window + 1, stride))


def window_means(q: torch.Tensor, window: int, stride: int,
                 min_count: int = 1, rows: int = 8) -> torch.Tensor:
    """The mean of each window's finite points (B, Wy, Wx), NaN for fewer
    than ``min_count``."""
    B, Ny, Nx = q.shape
    Wy, Wx = _anchors(Ny, window, stride), _anchors(Nx, window, stride)
    out = torch.full((B, Wy, Wx), torch.nan, dtype=q.dtype, device=q.device)
    for b in range(B):
        for r0 in range(0, Wy, rows):
            r1 = min(Wy, r0 + rows)
            p = q[b, r0 * stride:(r1 - 1) * stride + window]
            p = p.unfold(0, window, stride).unfold(1, window, stride)
            fin = torch.isfinite(p)
            n = fin.sum(dim=(-2, -1))
            tot = torch.where(fin, p, 0).sum(dim=(-2, -1))
            out[b, r0:r1] = torch.where(n >= min_count,
                                        tot / n.clamp(min=1), torch.nan)
    return out


def segments(L, v00, v01, v10, v11, y0, y1, x0, x1, latlon: bool):
    """The in-cell segment length of each crossed (cell, level): the
    segment table of ``core.contour_lengths`` (edge points by linear
    interpolation, 'low' saddles), haversine on the unit sphere (radians)
    or hypot."""
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
            return core._haversine(ya, xa, yb, xb)
        return torch.hypot(yb - ya, xb - xa)
    a00, a01, a10, a11 = (v > L for v in (v00, v01, v10, v11))
    code = a00.long() * 8 + a01.long() * 4 + a10.long() * 2 + a11.long()
    table = {0b1000: ("top", "lef"), 0b0111: ("top", "lef"),
             0b0100: ("top", "rig"), 0b1011: ("top", "rig"),
             0b0010: ("bot", "lef"), 0b1101: ("bot", "lef"),
             0b0001: ("bot", "rig"), 0b1110: ("bot", "rig"),
             0b1100: ("lef", "rig"), 0b0011: ("lef", "rig"),
             0b1010: ("top", "bot"), 0b0101: ("top", "bot"),
             0b1001: ("top", "lef"), 0b0110: ("top", "rig")}
    out = torch.zeros_like(L)
    for k, (p, r) in table.items():
        out = torch.where(code == k, seg(p, r), out)
    out = out + torch.where(code == 0b1001, seg("bot", "rig"), 0)
    return out + torch.where(code == 0b0110, seg("bot", "lef"), 0)


def window_lengths(q: torch.Tensor, lev: torch.Tensor, y: torch.Tensor,
                   x: torch.Tensor, window: int, stride: int, latlon: bool,
                   rows: int = 8) -> torch.Tensor:
    """The contour length inside each window of q (B, Ny, Nx) at its level
    lev (B, Wy, Wx); y, x the grid's coordinates (degrees if ``latlon``).
    NaN for a window with no length."""
    if latlon:
        y, x = y * core.D2R, x * core.D2R
    B, Ny, Nx = q.shape
    Wy, Wx = lev.shape[-2:]
    cells = window - 1
    lo_all, hi_all = _corner_ranges(q)
    totals = torch.zeros((B, Wy * Wx), dtype=q.dtype, device=q.device)
    for b in range(B):
        for r0 in range(0, Wy, rows):
            r1 = min(Wy, r0 + rows)
            span = slice(r0 * stride, (r1 - 1) * stride + cells)
            lo = lo_all[b, span].unfold(0, cells, stride).unfold(1, cells,
                                                                 stride)
            hi = hi_all[b, span].unfold(0, cells, stride).unfold(1, cells,
                                                                 stride)
            L = lev[b, r0:r1, :, None, None]
            wy, wx, ci, cj = torch.nonzero((lo <= L) & (L < hi),
                                           as_tuple=True)
            if wy.numel() == 0:
                continue
            i = (r0 + wy) * stride + ci
            j = wx * stride + cj
            Lp = lev[b, r0 + wy, wx]
            qb = q[b]
            seg = segments(Lp, qb[i, j], qb[i, j + 1], qb[i + 1, j],
                           qb[i + 1, j + 1], y[i], y[i + 1], x[j], x[j + 1],
                           latlon)
            totals[b].index_add_(0, (r0 + wy) * Wx + wx, seg)
    totals = totals.reshape(B, Wy, Wx)
    scale = core.R_EARTH if latlon else 1.0
    return torch.where(totals == 0, torch.nan, totals * scale)


def _corner_ranges(q: torch.Tensor):
    """[lo, hi) of each cell's corners, (inf, -inf) for a NaN corner."""
    c = torch.stack([q[:, :-1, :-1], q[:, :-1, 1:], q[:, 1:, :-1],
                     q[:, 1:, 1:]])
    bad = torch.isnan(c).any(0)
    return (torch.where(bad, torch.inf, c.amin(0)),
            torch.where(bad, -torch.inf, c.amax(0)))


def run(q, g, *, window: int, stride: int, min_count: int = 1) -> dict:
    means = window_means(q, window, stride, min_count)
    return dict(means=means,
                llen=window_lengths(q, means, g["lat"], g["lon"], window,
                                    stride, latlon=True))
