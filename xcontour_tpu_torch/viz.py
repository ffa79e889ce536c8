"""Matplotlib helpers for the reference's visual workflows.

A copy of ``xcontour_tpu/viz.py`` whose helpers take tensors (on any
device) or numpy arrays: every input goes through one host copy,
:func:`_np`.

The reference package itself has no plotting code — its visual layer lives in
the notebooks and ``tests/test_breaking.py`` (proplot/cartopy figures:
field map + extracted-contour overlay at test_breaking.py:273-312, the
log-Keff contourf in notebooks/1.Keff_atmos.ipynb, the length-vs-contour
spectrum at test_breaking.py:425-437, and the zonal-mean-vs-sorted-Q profile
pair in notebooks/2.LWA_atmos.ipynb).  Neither proplot nor cartopy is a
computation dependency, so this module reproduces those four figure shapes
with plain matplotlib and stays OUT of the package's import path — import it
explicitly (``from xcontour_tpu_torch import viz``); matplotlib is only
touched then.

Everything here takes tensors or numpy arrays — the outputs of the
pipelines/diagnostics — and returns the matplotlib Axes, so figures compose
with any user layout.  No styling opinions beyond the reference's defaults.
"""

from __future__ import annotations

import numpy as np

from .grid import to_numpy

try:  # matplotlib is optional for the package; required for this module
    import matplotlib
    import matplotlib.pyplot as plt
except ImportError as _e:  # pragma: no cover - image always ships matplotlib
    raise ImportError(
        "xcontour_tpu_torch.viz requires matplotlib (the compute package does "
        "not); install it or use the array outputs directly") from _e


def _ax(ax, **fig_kw):
    if ax is not None:
        return ax
    _, ax = plt.subplots(**fig_kw)
    return ax


def _np(a):
    """``a`` on the host (:func:`.grid.to_numpy`)."""
    return to_numpy(a)


def plot_field(field, lat, lon, *, ax=None, contours=None, cmap="jet",
               contour_kw=None, colorbar=True, **pcolormesh_kw):
    """Plane-field map with optional extracted-contour overlay.

    Reproduces the reference's breaking-contour figure
    (test_breaking.py:279-312): ``dataset[var].plot(cmap='jet')`` plus
    ``ax.plot(contour[:, 0], contour[:, 1], '.')`` per contour — without the
    cartopy projection layer (axes are plain lon/lat; seam-crossing contours
    from ``host.extract.find_contour(period=...)`` plot unbroken).

    field : (Ny, Nx) array; lat (Ny,), lon (Nx,).
    contours : optional iterable of (M, 2) [lon, lat] polylines — the
        convention of the breaking chain (`host.breaking.extract_contours`,
        `rescale_contours`, `breaking_contour`, `df_contours`).  NOTE:
        `host.extract.find_contour` returns the reference's (y, x) column
        order — pass ``c[:, ::-1]`` for those.
    Returns the Axes.
    """
    ax = _ax(ax, figsize=(10, 4))
    field, lat, lon = _np(field), _np(lat), _np(lon)
    m = ax.pcolormesh(lon, lat, field, cmap=cmap, shading="auto",
                      **pcolormesh_kw)
    if colorbar:
        ax.figure.colorbar(m, ax=ax)
    kw = dict(marker=".", linestyle="none", markersize=4, color="k")
    kw.update(contour_kw or {})
    for c in (contours or ()):
        c = _np(c)
        ax.plot(c[:, 0], c[:, 1], **kw)
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    return ax


def plot_keff(nkeff, yeq, *, coord=None, ax=None, log=True, levels=24,
              cmap="jet", colorbar=True, **contourf_kw):
    """Normalized effective diffusivity vs equivalent latitude.

    2-D input reproduces the Keff notebook's headline figure
    (notebooks/1.Keff_atmos.ipynb: ``np.log(nkeff).plot.contourf(cmap='jet',
    levels=...)``) — a contourf over (batch coordinate, equivalent latitude).
    1-D input draws the profile line.  ``log=True`` plots ln(nkeff) with
    non-positive/NaN lanes masked (empty contour bins), exactly the
    notebook's transform.

    nkeff : (B, N) or (N,); yeq matching (..., N) equivalent latitudes (deg);
    coord : optional (B,) batch coordinate (time/level) for the y axis.
    Returns the Axes.
    """
    ax = _ax(ax, figsize=(10, 4))
    nkeff, yeq = _np(nkeff).astype(float), _np(yeq).astype(float)
    with np.errstate(invalid="ignore", divide="ignore"):
        z = np.log(nkeff) if log else nkeff
    z = np.ma.masked_invalid(z)
    label = "ln(nKeff)" if log else "nKeff"
    if nkeff.ndim == 1:
        y = yeq if yeq.ndim == 1 else yeq[0]
        ax.plot(y, np.asarray(z), lw=1.5)
        ax.set_xlabel("equivalent latitude")
        ax.set_ylabel(label)
        return ax
    B, N = nkeff.shape
    coord = np.arange(B) if coord is None else _np(coord)
    y2 = np.broadcast_to(yeq if yeq.ndim == 2 else yeq[None, :],
                         (B, N)).astype(float).copy()
    # NaN Yeq lanes (empty contour bins) break contourf's coordinate grid:
    # mask their z and substitute a finite placeholder coordinate
    bad = ~np.isfinite(y2)
    if bad.any():
        z = np.ma.masked_where(bad, z)
        fill = np.ma.filled(
            np.ma.array(y2, mask=bad).mean(axis=1, keepdims=True), 0.0)
        y2 = np.where(bad, fill, y2)
    c2 = np.broadcast_to(coord[:, None], (B, N))
    m = ax.contourf(y2, c2, z, levels=levels, cmap=cmap, **contourf_kw)
    if colorbar:
        ax.figure.colorbar(m, ax=ax, label=label)
    ax.set_xlabel("equivalent latitude")
    ax.set_ylabel("batch coordinate")
    return ax


def plot_length_spectrum(lengths, contour_values, *, ax=None,
                         min_length=None, **plot_kw):
    """Contour length vs contour value — the wave-breaking spectrum panel
    (test_breaking.py:425-437: ``ax.plot(lengths, cs)``, axes swapped there;
    here length on y so the contour coordinate reads left-to-right).

    lengths, contour_values : (N,) arrays (NaN = empty contour, masked).
    min_length : optional horizontal reference line (e.g. the minimum
        latitude-circle length from `grid.latitude_lengths_at`).
    Returns the Axes.
    """
    ax = _ax(ax, figsize=(6, 4))
    lengths, cs = _np(lengths).astype(float), _np(contour_values)
    ok = np.isfinite(lengths)
    kw = dict(lw=1.5)
    kw.update(plot_kw)
    ax.plot(cs[ok], lengths[ok], **kw)
    if min_length is not None:
        ax.axhline(float(min_length), color="gray", ls="--", lw=1.0,
                   label="minimum length")
        ax.legend()
    ax.set_xlabel("contour value")
    ax.set_ylabel("contour length")
    return ax


def plot_sorted_profile(tracer, lat, q_sorted, yeq, *, ax=None, scale=1.0,
                        labels=("zonal mean", "sorted Q")):
    """Zonal-mean tracer profile vs the contour-sorted Q(Yeq) profile —
    the LWA notebook's diagnostic pair (notebooks/2.LWA_atmos.ipynb:
    ``ax.plot(tracer.mean('longitude'), latitude)`` against
    ``ax.plot(Q, latEq)``).

    tracer : (Ny, Nx) plane field (zonal mean taken here) or (Ny,) profile;
    lat (Ny,); q_sorted (N,) contour values at yeq (N,) equivalent latitudes.
    ``scale`` multiplies both curves (the notebook uses 1e5 for vorticity).
    Returns the Axes.
    """
    ax = _ax(ax, figsize=(5, 5))
    tracer, lat = _np(tracer).astype(float), _np(lat)
    q_sorted, yeq = _np(q_sorted).astype(float), _np(yeq).astype(float)
    prof = tracer.mean(axis=-1) if tracer.ndim == 2 else tracer
    ax.plot(prof * scale, lat, lw=1.5, label=labels[0])
    ok = np.isfinite(q_sorted) & np.isfinite(yeq)
    ax.plot(q_sorted[ok] * scale, yeq[ok], lw=1.5, ls="--", label=labels[1])
    ax.set_xlabel("tracer")
    ax.set_ylabel("latitude / equivalent latitude")
    ax.legend()
    return ax
