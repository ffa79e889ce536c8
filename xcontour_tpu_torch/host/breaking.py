"""Wave-breaking contour analysis: extraction, snapping, grouping, filtering.

A copy of ``xcontour_tpu/host/breaking.py`` (NumPy; pandas imported only
inside :func:`df_contours`) whose chain also takes tensors for the field
and its coordinates: :func:`breaking_contour` copies them to the host once.

Host-side re-design of the experimental workflow in reference
tests/test_breaking.py:44-234 — detecting Rossby-wave breaking by extracting a
PV contour, snapping it to the grid, stitching pieces across the periodic
longitude boundary, and selecting the circumpolar contour.  The reference
builds this from skimage + scipy KD-trees + ad-hoc list scans; here the
pieces are:

* extraction — the native marching-squares traversal (host/native.py);
* snapping — direct nearest-grid-index rounding (the grid is rectilinear, so
  a KD-tree over the full meshgrid is O(N log N) work for an O(1) lookup);
* grouping — union-find over segment endpoints that meet at the periodic
  boundary within a latitude overlap window;
* filtering/selection — longitude-coverage tests as in the reference.

Contours are (K, 2) arrays with columns (lon, lat) in degrees, matching the
reference's column convention for this workflow (tests/test_breaking.py:65).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..grid import to_numpy
from .native import find_contours


def extract_contours(data: np.ndarray, lat: np.ndarray, lon: np.ndarray,
                     level: float) -> List[np.ndarray]:
    """Marching-squares polylines in (lon, lat) degrees
    (reference ``ex_contours``, tests/test_breaking.py:43-66)."""
    segs = find_contours(np.asarray(data, np.float64), float(level))
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    out = []
    for seg in segs:
        la = np.interp(seg[:, 0], np.arange(lat.size), lat)
        lo = np.interp(seg[:, 1], np.arange(lon.size), lon)
        out.append(np.c_[lo, la])
    return out


def rescale_contours(contours: List[np.ndarray], lat: np.ndarray,
                     lon: np.ndarray) -> List[np.ndarray]:
    """Snap contour points onto the grid and drop consecutive duplicates
    (reference ``rescale_contours``, tests/test_breaking.py:69-100 — same
    result as its KD-tree query on a rectilinear grid)."""
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    out = []
    for contour in contours:
        iy = _snap_index(lat, contour[:, 1])
        ix = _snap_index(lon, contour[:, 0])
        pts = np.c_[lon[ix], lat[iy]]
        keep = np.ones(len(pts), bool)
        seen = set()
        for i, p in enumerate(map(tuple, pts)):
            if p in seen:
                keep[i] = False
            else:
                seen.add(p)
        out.append(pts[keep])
    return out


def _snap_index(coord: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Nearest-grid-index of each value on an increasing coordinate."""
    if coord[0] > coord[-1]:
        raise ValueError("coordinate must be increasing for snapping")
    mid = 0.5 * (coord[:-1] + coord[1:])
    return np.clip(np.searchsorted(mid, vals), 0, coord.size - 1)


def group_contours(contours: List[np.ndarray], y_overlap: float = 1.0,
                   lon_border: Sequence[float] = (0.0, 360.0)
                   ) -> List[np.ndarray]:
    """Stitch contour pieces whose endpoints meet (same longitude, or opposite
    sides of the periodic border) within ``y_overlap`` degrees of latitude —
    union-find over endpoints (reference ``group_contours``,
    tests/test_breaking.py:103-173)."""
    n = len(contours)
    if n == 0:
        return []
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        parent[find(i)] = find(j)

    ends = []
    for k, c in enumerate(contours):
        ends.append((k, c[0, 0], c[0, 1]))
        ends.append((k, c[-1, 0], c[-1, 1]))
    lo, hi = lon_border
    for a in range(len(ends)):
        ka, xa, ya = ends[a]
        for b in range(a + 1, len(ends)):
            kb, xb, yb = ends[b]
            if ka == kb:
                continue
            same_lon = xa == xb
            across = {xa, xb} == {float(lo), float(hi)} or \
                (abs(xa - xb) >= (hi - lo) - 1e-9)
            if (same_lon or across) and abs(ya - yb) <= y_overlap:
                union(ka, kb)

    groups = {}
    for k in range(n):
        groups.setdefault(find(k), []).append(contours[k])

    out = []
    for pieces in groups.values():
        if len(pieces) == 1:
            out.append(pieces[0])
            continue
        # chain pieces: start from the longest, repeatedly append the piece
        # whose head latitude continues the current tail
        # (reference tests/test_breaking.py:154-170)
        pieces = sorted(pieces, key=len, reverse=True)
        chain = [pieces[0]]
        rest = pieces[1:]
        while rest:
            tail_lat = chain[-1][-1, 1]
            pick = 0
            for i, item in enumerate(rest):
                if abs(item[0, 1] - tail_lat) <= y_overlap:
                    pick = i
                    break
            chain.append(rest.pop(pick))
        out.append(np.concatenate(chain, axis=0))
    return out


def filter_contours(contours: List[np.ndarray], lon: np.ndarray,
                    x_extent: float = 1.0) -> List[np.ndarray]:
    """Keep contours covering at least ``x_extent`` of the longitudes
    (reference ``filter_contours``, tests/test_breaking.py:176-198)."""
    lon = np.asarray(lon)
    out = []
    for c in contours:
        cover = len(np.unique(np.round(c[:, 0]))) / lon.size
        if cover >= x_extent:
            out.append(c)
    return out


def single_contour(contours: List[np.ndarray], lon: np.ndarray,
                   x_extent: float = 1.0) -> np.ndarray:
    """Select the circumpolar contour: the most-equatorward full-coverage one
    (reference ``single_contours``, tests/test_breaking.py:201-231)."""
    lon = np.asarray(lon)
    if not contours:
        raise ValueError("no contour pieces to select from — the level is "
                         "outside the field's range or fully masked")
    coverage = [len(np.unique(np.round(c[:, 0]))) / lon.size for c in contours]
    full = [i for i, cov in enumerate(coverage) if cov >= x_extent]
    if len(full) > 1:
        mean_lat = [np.mean(contours[i][:, 1]) for i in full]
        return contours[full[int(np.argmin(mean_lat))]]
    return contours[int(np.argmax(coverage))]


def df_contours(contours):
    """Tabulate a contour (or list of contour pieces) as a pandas DataFrame
    with columns ``lon``/``lat`` (reference ``df_contours``,
    tests/test_breaking.py:236-255).

    The reference's list branch is dead code (it compares ``type(...)`` to
    the *string* ``"list"``), so lists crash there; here the intended
    semantics — chain the pieces, then tabulate — actually runs.
    """
    import pandas as pd
    if isinstance(contours, list):
        temp = np.concatenate([np.asarray(c, np.float64) for c in contours],
                              axis=0) if contours else np.empty((0, 2))
    else:
        temp = np.asarray(contours, np.float64)
    return pd.DataFrame({"lon": temp[:, 0].tolist(),
                         "lat": temp[:, 1].tolist()})


def breaking_contour(data: np.ndarray, lat: np.ndarray, lon: np.ndarray,
                     level: float, y_overlap: float = 1.0,
                     x_extent: float = 1.0, snap: bool = True) -> np.ndarray:
    """Full chain: extract -> (snap) -> group -> select the circumpolar
    contour whose meanders mark wave breaking."""
    data, lat, lon = to_numpy(data), to_numpy(lat), to_numpy(lon)
    cs = extract_contours(data, lat, lon, level)
    if snap:
        cs = rescale_contours(cs, lat, lon)
    cs = [c for c in cs if len(c) >= 2]
    cs = group_contours(cs, y_overlap, (float(np.min(lon)), float(np.max(lon))))
    return single_contour(cs, lon, x_extent)
