"""Buoyancy on an MITgcm x-z section over a ridge: a stable linear
stratification displaced by internal waves, as xcontour's LAPE case
(``notebooks/3.LAPE_ocean.ipynb``, ``tests/test_LAPE.py``) reads it from
``Data/internalwave.nc``, which is not at hand.

:func:`section` gives the grid of the configuration: cell centres Z
(descending in memory, as MITgcm writes them) and x, and the open fraction
hFacC of each cell under a Gaussian ridge, with MITgcm's ``hFacMin`` rule.

:func:`make` gives B snapshots of b = alpha g (T - T0) with the linear
equation of state of ``tests/test_LAPE.py``: T runs linearly from
``T_bottom`` at the section's floor to ``T_top`` at the surface, read at the
displaced depth z - eta(x, z), plus Gaussian noise of ``noise_K``, and NaN
over rock (hFacC = 0), as MITgcm's zeros there are masked.  The
displacement of each snapshot is a sum of ``modes`` vertical modes
sin(m pi z / H) cos(2 pi n x / L + phi), H the floor's depth, the
horizontal wavenumber n drawn from 1 to ``max_wavenumber`` (periodic over
the section's length L), the mode's weight from U(0.5, 1.5) and phi from
U(0, 2 pi); then it is scaled so that its steepness, the largest
d eta / dz over the fluid cells, is the snapshot's ``s``.

The draw of s: a column overturns (b decreases upwards over a band, noise
aside) where d eta / dz > 1.  Half of each step's snapshots, B // 2 of
them chosen at random, draw s from U(``overturned``) (both ends
above 1: overturned), the rest from U(``stable``) (both ends below 1:
statically stable); so every step holds B // 2 overturned snapshots, at
least a quarter of it for B >= 2.  :func:`steepness` gives the draws.

All draws but the noise are made on the host from (seed, t); the noise and
the field are made on the device.  Nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch


def section(grid: dict):
    """(Z, x, hFacC) in float64 numpy: ``grid``'s centres and the open
    fraction of each (Z, x) cell above the ridge's bottom."""
    z, x, r = grid["z"], grid["x"], grid["ridge"]
    Z = z["first"] + z["step"] * np.arange(z["num"])
    X = x["first"] + x["step"] * np.arange(x["num"])
    dz = abs(z["step"])
    bottom = -r["depth"] + r["height"] * np.exp(-((X - r["x0"])
                                                  / r["width"]) ** 2)
    top = Z + dz / 2                                    # upper interfaces
    h = np.clip((top[:, None] - bottom[None, :]) / dz, 0.0, 1.0)
    hmin = grid["hFacMin"]
    h = np.where(h < hmin / 2, 0.0, np.where(h < hmin, hmin, h))
    return Z, X, h


def steepness(spec: dict, B: int, seed: int, t: int) -> np.ndarray:
    """Each snapshot's steepness s (B,), as :func:`make` draws it."""
    return _draws(spec, B, seed, t)[0]


def _draws(spec, B, seed, t):
    rng = np.random.default_rng([seed, t])
    over = rng.permutation(B) < B // 2
    lo = np.where(over, spec["overturned"][0], spec["stable"][0])
    hi = np.where(over, spec["overturned"][1], spec["stable"][1])
    s = lo + (hi - lo) * rng.uniform(size=B)
    M = spec["modes"]
    n = rng.integers(1, spec["max_wavenumber"] + 1, size=(B, M))
    c = rng.uniform(0.5, 1.5, size=(B, M))
    phi = rng.uniform(0.0, 2 * np.pi, size=(B, M))
    noise_seed = int(rng.integers(0, 2 ** 62))
    return s, n, c, phi, noise_seed


def make(spec: dict, Z, X, hFacC, B: int, seed: int, t: int, device):
    s, n, c, phi, noise_seed = _draws(spec, B, seed, t)
    f64 = dict(dtype=torch.float64, device=device)
    H = abs(Z[-1] + (Z[-1] - Z[-2]) / 2)                   # the floor's depth
    L = float(X[-1] - X[0] + (X[1] - X[0]))
    z = torch.as_tensor(Z, **f64)[None, :, None]             # (1, Ny, 1)
    x = torch.as_tensor(X, **f64)[None, None, :]
    eta = deta = 0.0
    for j in range(spec["modes"]):                         # mode m = j + 1
        k = torch.as_tensor(2 * np.pi * n[:, j] / L, **f64)[:, None, None]
        wave = torch.as_tensor(c[:, j], **f64)[:, None, None] * torch.cos(
            k * x + torch.as_tensor(phi[:, j], **f64)[:, None, None])
        arg = (j + 1) * np.pi * z / H
        eta = eta + torch.sin(arg) * wave                  # (B, Ny, Nx)
        deta = deta + (j + 1) * np.pi / H * torch.cos(arg) * wave
    fluid = torch.as_tensor(hFacC > 0, device=device)
    steep = torch.where(fluid, deta, -torch.inf).amax(dim=(-2, -1))
    eta = eta * (torch.as_tensor(s, **f64) / steep)[:, None, None]
    zd = z - eta
    T = spec["T_bottom"] + (spec["T_top"] - spec["T_bottom"]) * (zd + H) / H
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    T = T + spec["noise_K"] * torch.randn(T.shape, generator=gen, **f64)
    b = spec["alpha"] * spec["g"] * (T - spec["T0"])
    return torch.where(fluid, b, torch.nan).float()
