"""Synthetic isentropic PV, the port's stand-in for the reference's PV.nc.

Counterpart of ``synth_pv`` in ``xcontour_tpu/utils/synth.py``, copied as
pure numpy so both packages produce the same arrays from the same seed.
"""

from __future__ import annotations

import numpy as np

from .constants import Rearth, omega


# the recorded PV.nc level coordinate: the standard ERA isentropic-surface
# ladder (15 levels)
ERA_THETA_LEVELS = np.array([265, 275, 285, 300, 315, 330, 350, 370, 395,
                             430, 475, 530, 600, 700, 850], np.int32)


def synth_pv(nlev: int = 7, nlat: int = 181, nlon: int = 360, seed: int = 1):
    """ERA-like isentropic PV snapshot: pv(level, latitude, longitude) +
    grdSpv, float32, on the recorded Data/PV.nc schema (latitude -90..90
    ascending, longitude 0..360 periodic, level from ERA_THETA_LEVELS,
    subsampled when ``nlev`` < 15).

    The field is the classic wave-breaking surrogate: planetary-vorticity
    background 2*Omega*sin(lat) amplitude-modulated per level, stirred by a
    few zonal wavenumbers with level-dependent phase.

    Returns (dict of numpy arrays, dict of dim tuples).
    """
    rng = np.random.default_rng(seed)
    if nlev == len(ERA_THETA_LEVELS):
        level = ERA_THETA_LEVELS.copy()
    else:   # subsample the recorded ladder, keeping its range and int dtype
        pos = np.linspace(0, len(ERA_THETA_LEVELS) - 1, nlev)
        level = np.round(np.interp(pos, np.arange(len(ERA_THETA_LEVELS)),
                                   ERA_THETA_LEVELS)).astype(np.int32)
    lat = np.linspace(-90.0, 90.0, nlat)
    lon = np.linspace(0.0, 360.0 - 360.0 / nlon, nlon)
    phi = np.deg2rad(lat)[None, :, None]
    lam = np.deg2rad(lon)[None, None, :]

    scale = (1.0 + (level - level[0]) / (level[-1] - level[0]) * 30.0)[:, None, None]
    pv = 2.0 * omega * np.sin(phi) * scale
    for k in (3, 5, 8):
        amp = 0.25 * rng.uniform(0.5, 1.5, size=(nlev, 1, 1))
        ph = rng.uniform(0, 2 * np.pi, size=(nlev, 1, 1))
        pv = pv + (2.0 * omega * scale * amp * np.cos(phi) ** 2 *
                   np.sin(k * lam + ph) * np.sin(2 * phi))
    # a wave that does NOT vanish at the equator: without it the equator row
    # is exactly constant and sits knife-edge on the central contour bin
    pv = pv + 0.05 * 2.0 * omega * scale * np.cos(phi) * np.sin(3 * lam)

    # squared gradient on the sphere (as the reference ships pre-computed)
    d2r = np.pi / 180.0
    dy = (lat[1] - lat[0]) * d2r * Rearth
    dx = np.cos(np.deg2rad(lat))[None, :, None] * (lon[1] - lon[0]) * d2r * Rearth
    gx = (np.roll(pv, -1, axis=-1) - np.roll(pv, 1, axis=-1)) / (2 * dx)
    gy = np.gradient(pv, axis=-2) / dy
    grdSpv = gx ** 2 + gy ** 2

    variables = dict(level=level, latitude=lat.astype(np.float32),
                     longitude=lon.astype(np.float32),
                     pv=pv.astype(np.float32), grdSpv=grdSpv.astype(np.float32))
    dims = dict(level=("level",), latitude=("latitude",), longitude=("longitude",),
                pv=("level", "latitude", "longitude"),
                grdSpv=("level", "latitude", "longitude"))
    return variables, dims
