"""Absolute vorticity of a barotropic flow: planetary vorticity 2 Omega
sin(lat) plus relative vorticity with the k^-1 Fourier amplitudes of
two-dimensional turbulence's enstrophy cascade (energy spectrum k^-3),
white noise shaped on the device, each snapshot scaled to the rms
``rms`` (1/s).  The noise comes from a generator on the device seeded from
(seed, t)."""

from __future__ import annotations

import numpy as np
import torch

OMEGA = 7.292e-5


def make(spec: dict, lat, lon, B: int, seed: int, t: int, device):
    sub = int(np.random.default_rng([seed, t]).integers(0, 2 ** 62))
    gen = torch.Generator(device=device).manual_seed(sub)
    Ny, Nx = len(lat), len(lon)
    noise = torch.randn((B, Ny, Nx), generator=gen, device=device,
                        dtype=torch.float64)
    spec_c = torch.fft.rfft2(noise)
    ky = torch.fft.fftfreq(Ny, 1 / Ny, device=device, dtype=torch.float64)
    kx = torch.fft.rfftfreq(Nx, 1 / Nx, device=device, dtype=torch.float64)
    k = torch.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    shape = torch.where((k >= 1) & (k <= spec["k_max"]), 1 / k.clamp(min=1),
                        0)
    zeta = torch.fft.irfft2(spec_c * shape, s=(Ny, Nx))
    zeta = zeta / zeta.square().mean(dim=(-2, -1), keepdim=True).sqrt()
    phi = torch.deg2rad(torch.as_tensor(lat, dtype=torch.float64,
                                        device=device))
    f = 2 * OMEGA * torch.sin(phi)[None, :, None]
    return (f + spec["rms"] * zeta).float()
