"""Isentropic potential vorticity in the wave-breaking surrogate of the
xcontour_tpu_torch synthetic PV (planetary vorticity amplitude-modulated
per level, stirred by zonal wavenumbers 3, 5 and 8 with random amplitude
and phase, and a wave that does not vanish at the equator), with a
below-ground NaN box on the lowest ``nan_levels`` levels as ERA5 has
beneath the ground.  The random draws (a few per level) are made on the
host from (seed, t); the field is built on the device."""

from __future__ import annotations

import numpy as np
import torch

OMEGA = 7.292e-5


def make(spec: dict, lat, lon, B: int, seed: int, t: int, device):
    rng = np.random.default_rng([seed, t])
    theta = np.asarray(spec["levels"], np.float64)
    if len(theta) != B:
        raise ValueError(f"{len(theta)} levels for a batch of {B}")
    f64 = dict(dtype=torch.float64, device=device)
    phi = torch.deg2rad(torch.as_tensor(lat, **f64))[None, :, None]
    lam = torch.deg2rad(torch.as_tensor(lon, **f64))[None, None, :]
    scale = torch.as_tensor(1 + (theta - theta[0]) / (theta[-1] - theta[0])
                            * 30, **f64)[:, None, None]
    pv = 2 * OMEGA * torch.sin(phi) * scale
    for k in (3, 5, 8):
        amp = torch.as_tensor(0.25 * rng.uniform(0.5, 1.5, (B, 1, 1)), **f64)
        ph = torch.as_tensor(rng.uniform(0, 2 * np.pi, (B, 1, 1)), **f64)
        pv = pv + (2 * OMEGA * scale * amp * torch.cos(phi) ** 2
                   * torch.sin(k * lam + ph) * torch.sin(2 * phi))
    pv = pv + 0.05 * 2 * OMEGA * scale * torch.cos(phi) * torch.sin(3 * lam)
    pv = pv.float()
    lat_t = torch.as_tensor(lat, **f64)
    lon_t = torch.as_tensor(lon, **f64)
    for lev in range(min(int(spec.get("nan_levels", 0)), B)):
        lat0 = rng.uniform(25.0, 35.0)
        lon0 = rng.uniform(70.0, 90.0)
        rows = (lat_t >= lat0) & (lat_t <= lat0 + 8.0 - 2.0 * lev)
        cols = (lon_t >= lon0) & (lon_t <= lon0 + 25.0 - 5.0 * lev)
        pv[lev][rows[:, None] & cols[None, :]] = float("nan")
    return pv
