"""Synthetic data, the port's stand-ins for the reference's PV.nc and
internalwave.nc.

Counterparts of ``synth_pv`` and ``synth_internalwave`` in
``xcontour_tpu/utils/synth.py``, copied as pure numpy so both packages
produce the same arrays from the same seed.
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


def synth_internalwave(nt: int = 3, nz: int = 100, nx: int = 448,
                       seed: int = 2):
    """MITgcm-like internal-wave x-z slices on the Data/internalwave.nc
    schema: the file was written by the reference's own
    add_MITgcm_missing_metrics + squeeze (creation code recorded in
    tests/test_LAPE.py:17-25), so it carries the COMPLETED metric set that
    notebooks/3.LAPE_ocean.ipynb cell 1 declares to xgcm.Grid — X distances
    dxG/dxF/dxC/dxV on (XC,), vertical drF on (Z,), partial-cell drW/drS/drC
    = hFac*drF on (Z, XC) (reference utils.py:443-448), and the X-Z plane
    area yA = drF*hFacC*dxF (utils.py:468-469) — plus THETA(time, Z, XC)
    float32, maskC = (hFacC > 0), and the hFac fields themselves.

    x in [0, 8960] m, Z in (-200, 0); stable stratification displaced by a
    breaking internal wave of growing amplitude per snapshot, over a ridge
    whose partial bottom cells give genuine fractional hFacC.
    """
    rng = np.random.default_rng(seed)
    hgrid = 8960.0 / nx
    dz = 200.0 / nz
    xc = (np.arange(nx) + 0.5) * hgrid
    zc = -(np.arange(nz) + 0.5) * dz                  # 0 -> -200, decreasing
    drF = np.full(nz, dz)

    # ridge topography: bottom depth varies with x; cells cut by the ridge
    # keep the MITgcm fractional open thickness hFacC in (0, 1)
    depth = -200.0 + 60.0 * np.exp(-((xc - 5000.0) / 1200.0) ** 2)
    ztop = -np.arange(nz) * dz                        # cell upper interfaces
    hFacC = np.clip((ztop[:, None] - depth[None, :]) / dz, 0.0, 1.0) \
        .astype(np.float32)
    maskC = (hFacC > 0).astype(np.float32)

    T = np.empty((nt, nz, nx))
    for t in range(nt):
        amp = 20.0 * (t + 1)
        eta = amp * np.sin(2 * np.pi * xc / 4480.0 + 0.3 * t)
        zdisp = zc[:, None] + eta[None, :] * np.exp(zc[:, None] / 80.0)
        T[t] = 20.0 + 8.0 * (zdisp / 200.0) \
            + 0.02 * rng.standard_normal((nz, nx))
    T = np.where(maskC[None] > 0, T, 0.0)              # MITgcm zeros over rock

    # staggered open fractions: west face = min of the adjacent centers
    # (periodic X, as the reference run was), south face = center (the Y
    # dimension was squeezed out of this 2-D slice)
    hFacW = np.minimum(hFacC, np.roll(hFacC, 1, axis=-1)).astype(np.float32)
    hFacS = hFacC.copy()

    dxF = np.full(nx, hgrid)                           # (XC,) after squeeze
    yA = drF[:, None] * hFacC * dxF[None, :]           # utils.py:468-469

    f32 = lambda a: np.asarray(a, np.float32)
    variables = dict(time=np.arange(nt, dtype=np.int32),
                     Z=f32(zc), XC=f32(xc),
                     THETA=T.astype(np.float32), maskC=maskC,
                     hFacC=hFacC, hFacW=hFacW, hFacS=hFacS,
                     drF=f32(drF),
                     drW=f32(hFacW * drF[:, None]),    # utils.py:443-444
                     drS=f32(hFacS * drF[:, None]),    # utils.py:445-446
                     drC=f32(hFacC * drF[:, None]),    # utils.py:447-448
                     dxF=f32(dxF), dxG=f32(dxF), dxC=f32(dxF),
                     dxV=f32(dxF),                     # uniform grid
                     yA=f32(yA))
    dims = dict(time=("time",), Z=("Z",), XC=("XC",),
                THETA=("time", "Z", "XC"), maskC=("Z", "XC"),
                hFacC=("Z", "XC"), hFacW=("Z", "XC"), hFacS=("Z", "XC"),
                drF=("Z",), drW=("Z", "XC"), drS=("Z", "XC"),
                drC=("Z", "XC"),
                dxF=("XC",), dxG=("XC",), dxC=("XC",), dxV=("XC",),
                yA=("Z", "XC"))
    return variables, dims

