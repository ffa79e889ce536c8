"""Grid metrics: the L1 layer.

Counterpart of ``xcontour_tpu/grid.py``.  A :class:`Grid` is a frozen
dataclass of tensors: cell areas ``dA``, zonal/meridional line elements
``dxF``/``dyF``, the coordinate vectors, an optional fluid mask, and static
metadata (dimension names, lat/lon flag, x periodicity, y-wall boundary
condition).  The metric maths runs in float64 numpy exactly as in the JAX
package, so both packages produce the same metrics bit for bit; only the
final cast to the working dtype and device differs.

Conventions: the 2-D analysis plane is the LAST TWO axes of a field,
ordered ``(ydef, xdef)``; leading axes are batch (time, level, ...).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .utils.constants import Rearth as _REARTH


def _edges_from_centers(c: np.ndarray) -> np.ndarray:
    """Cell-edge positions: interior midpoints, end edges extrapolated by half
    the boundary spacing."""
    c = np.asarray(c, dtype=np.float64)
    e = np.empty(c.size + 1, dtype=np.float64)
    e[1:-1] = 0.5 * (c[:-1] + c[1:])
    e[0] = c[0] - 0.5 * (c[1] - c[0])
    e[-1] = c[-1] + 0.5 * (c[-1] - c[-2])
    return e


def is_periodic_lon(lon: np.ndarray, period: float = 360.0) -> bool:
    """Periodicity sniffing with the reference's 1e-4 relative-to-delta
    tolerance."""
    lon = np.asarray(lon, dtype=np.float64)
    if lon.size <= 1:
        return False
    delta = lon[1] - lon[0]
    start = lon[-1] + delta - period
    return bool(abs((start - lon[0]) / delta) <= 1e-4)


def _device(device) -> torch.device:
    """The constructors' device: ``None`` means the card, and there is no
    silent fall-back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the grid and table constructors "
                           "run on the card by default; pass device='cpu' "
                           "to build on the CPU")
    return torch.device("cuda")


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Plane metrics for contour analysis (tensors plus static metadata)."""

    ydef: torch.Tensor  # (Ny,)  equivalent-dim coordinate (deg lat, or m depth)
    xdef: torch.Tensor  # (Nx,)  along-plane coordinate (deg lon, or m)
    dA: torch.Tensor    # (Ny, Nx) cell areas (m^2)
    dxF: torch.Tensor   # (Ny, Nx) x line element through cell center (m)
    dyF: torch.Tensor   # (Ny, Nx) y line element through cell center (m)
    mask: Optional[torch.Tensor] = None  # (Ny, Nx) 1=fluid, 0=solid; None => all fluid
    dim_names: Tuple[str, str] = ("y", "x")
    latlon: bool = False
    periodic_x: bool = False
    # y-wall boundary condition of the finite-difference stencils:
    # 'extend', 'reflect' or 'fill'
    bc_y: str = "extend"

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.ydef.shape[0], self.xdef.shape[0])

    def to(self, device) -> "Grid":
        """The same grid with every tensor on ``device``."""
        mask = None if self.mask is None else self.mask.to(device)
        return dataclasses.replace(
            self, ydef=self.ydef.to(device), xdef=self.xdef.to(device),
            dA=self.dA.to(device), dxF=self.dxF.to(device),
            dyF=self.dyF.to(device), mask=mask)

    def fluid_mask(self, dtype=torch.float32) -> torch.Tensor:
        if self.mask is None:
            return torch.ones(self.shape, dtype=dtype, device=self.dA.device)
        return self.mask.to(dtype)

    def total_area(self) -> torch.Tensor:
        """The fluid area: dA summed over the fluid cells."""
        return torch.sum(self.dA * self.fluid_mask(self.dA.dtype))

    def integrate(self, field: torch.Tensor) -> torch.Tensor:
        """The NaN-skipping area integral of ``field`` (..., Ny, Nx) over the
        plane."""
        return torch.nansum(field * self.dA, dim=(-2, -1))


def to_numpy(a) -> np.ndarray:
    """``a`` as a numpy array: a tensor (on any device) is detached and
    copied to the host once, since ``np.asarray`` of a CUDA tensor raises;
    anything else goes through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_host(grid: Grid) -> Grid:
    """The same grid with every tensor on the CPU: the port's host copy
    (the JAX package's ``to_host`` gives numpy leaves, so that a jitted
    function closing over the grid embeds no device arrays; here it is a
    copy to CPU memory, as ``grid.to('cpu')``)."""
    return grid.to("cpu")


def from_latlon(lat, lon, Rearth: float = _REARTH,
                mask: Optional[np.ndarray] = None,
                dim_names: Tuple[str, str] = ("latitude", "longitude"),
                dtype=torch.float32, exact_area: bool = True,
                bc_y: str = "extend", device=None) -> Grid:
    """Spherical metrics from 1-D lat/lon center coordinates (degrees):
    exact spherical cell areas with pole clamping, and dxF as the Y-average
    of the edge zonal elements with the cos(+-90) threshold.
    ``exact_area=False`` selects the legacy rectangle areas dyF * dxF.
    ``device=None`` builds on the card (every constructor here does so, and
    raises where there is none)."""
    device = _device(device)
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    if lat.size > 1 and lat[0] > lat[-1]:
        warnings.warn(
            "from_latlon: latitude is DESCENDING (the ERA5 90..-90 storage "
            "convention).  The contour chain accumulates area from the "
            "south pole (reference semantics) and will return wrong "
            "equivalent latitudes / LWA on descending rows — flip the "
            "coordinate and the field rows to ascending first.", stacklevel=2)
    latE = _edges_from_centers(lat)
    lonE = _edges_from_centers(lon)
    periodic = is_periodic_lon(lon)

    d2r = np.pi / 180.0
    latEc = np.clip(latE, -90.0, 90.0)   # pole processing
    dlam = np.diff(lonE)  # (Nx,) in degrees
    if periodic:
        dlam = np.where(dlam < 0, dlam + 360.0, dlam)
        dlam = np.where(dlam > 360.0, dlam - 360.0, dlam)

    # zonal line elements at edges, pole-clamped
    dxG = np.cos(latEc * d2r)[:, None] * dlam[None, :] * d2r * Rearth
    dxG = np.abs(dxG)
    dxG = np.where(dxG < 1e-15, 0.0, dxG)
    dxF = 0.5 * (dxG[:-1, :] + dxG[1:, :])

    # |diff|: dyF is a line element (m, positive) for either lat direction
    dyF = np.abs(np.diff(latE) * d2r * Rearth)[:, None] \
        * np.ones_like(dlam)[None, :]

    if exact_area:
        # exact spherical areas: R^2 |sin(phi1)-sin(phi2)| dlambda
        sinphi = np.sin(latEc * d2r)
        band = np.abs(np.diff(sinphi))  # (Ny,)
        rA = (Rearth * Rearth) * band[:, None] * (dlam[None, :] * d2r)
    else:
        rA = dyF * dxF

    return Grid(
        ydef=_tensor(lat, dtype, device), xdef=_tensor(lon, dtype, device),
        dA=_tensor(rA, dtype, device), dxF=_tensor(dxF, dtype, device),
        dyF=_tensor(dyF, dtype, device),
        mask=None if mask is None else _tensor(mask, dtype, device),
        dim_names=dim_names, latlon=True, periodic_x=periodic, bc_y=bc_y)


def from_cartesian(y, x, mask: Optional[np.ndarray] = None,
                   dim_names: Tuple[str, str] = ("y", "x"),
                   periodic_x: bool = False, dtype=torch.float32,
                   device=None) -> Grid:
    """Cartesian plane metrics from 1-D coordinates in meters."""
    device = _device(device)
    y = np.asarray(y, np.float64)
    x = np.asarray(x, np.float64)
    dy = np.abs(np.diff(_edges_from_centers(y)))
    dx = np.abs(np.diff(_edges_from_centers(x)))
    dA = dy[:, None] * dx[None, :]
    return Grid(
        ydef=_tensor(y, dtype, device), xdef=_tensor(x, dtype, device),
        dA=_tensor(dA, dtype, device),
        dxF=_tensor(np.broadcast_to(dx[None, :], dA.shape), dtype, device),
        dyF=_tensor(np.broadcast_to(dy[:, None], dA.shape), dtype, device),
        mask=None if mask is None else _tensor(mask, dtype, device),
        dim_names=dim_names, latlon=False, periodic_x=periodic_x)


def from_xz(z, x, hFacC: Optional[np.ndarray] = None,
            mask: Optional[np.ndarray] = None,
            dim_names: Tuple[str, str] = ("Z", "XC"),
            periodic_x: bool = True, dtype=torch.float32,
            device=None) -> Grid:
    """Vertical-plane (X-Z) metrics, MITgcm style: ``dA`` is the face area
    yA = drF * hFacC * dxF with partial cells, ``dyF`` = drF * hFacC, and
    drF comes from the center spacing with the first level mirrored.  The
    depth coordinate may decrease (MITgcm's Z runs 0 -> -H)."""
    device = _device(device)
    z = np.asarray(z, np.float64)
    x = np.asarray(x, np.float64)
    dx = np.abs(np.diff(_edges_from_centers(x)))
    tmp = np.diff(z)
    tmp = np.concatenate([[z[0] - tmp[0]], z])
    drF = np.abs(np.diff(tmp))
    hf = np.ones((z.size, x.size)) if hFacC is None else np.asarray(hFacC, np.float64)
    yA = drF[:, None] * hf * dx[None, :]
    return Grid(
        ydef=_tensor(z, dtype, device), xdef=_tensor(x, dtype, device),
        dA=_tensor(yA, dtype, device),
        dxF=_tensor(np.broadcast_to(dx[None, :], yA.shape), dtype, device),
        dyF=_tensor(np.broadcast_to(drF[:, None], yA.shape) * hf, dtype, device),
        mask=None if mask is None else _tensor(mask, dtype, device),
        dim_names=dim_names, latlon=False, periodic_x=periodic_x)


def from_metrics(ydef, xdef, dA, dxF=None, dyF=None, mask=None,
                 dim_names: Tuple[str, str] = ("y", "x"), latlon: bool = False,
                 periodic_x: bool = False, dtype=torch.float32,
                 device=None) -> Grid:
    """Wrap externally supplied metrics (e.g. read from an MITgcm dataset).
    1-D line elements are broadcast to the plane shape."""
    device = _device(device)
    dA = _tensor(dA, dtype, device)
    dxF = torch.ones_like(dA) if dxF is None else _tensor(dxF, dtype, device)
    dyF = torch.ones_like(dA) if dyF is None else _tensor(dyF, dtype, device)
    return Grid(
        ydef=_tensor(ydef, dtype, device), xdef=_tensor(xdef, dtype, device),
        dA=dA, dxF=torch.broadcast_to(dxF, dA.shape).contiguous(),
        dyF=torch.broadcast_to(dyF, dA.shape).contiguous(),
        mask=None if mask is None else _tensor(mask, dtype, device),
        dim_names=dim_names, latlon=latlon, periodic_x=periodic_x)


def grid_from_numpy(ydef, xdef, dA, dxF, dyF, mask=None, *,
                    dim_names: Tuple[str, str] = ("y", "x"),
                    latlon: bool = False, periodic_x: bool = False,
                    bc_y: str = "extend", dtype=None, device=None) -> Grid:
    """Carry a grid across from numpy: the leaves of an ``xcontour_tpu``
    Grid (as numpy arrays) plus its static fields become the port's Grid.
    ``dtype=None`` keeps each array's own dtype."""
    device = _device(device)

    def t(a):
        out = torch.as_tensor(np.array(a), device=device)
        return out if dtype is None else out.to(dtype)
    return Grid(ydef=t(ydef), xdef=t(xdef), dA=t(dA), dxF=t(dxF), dyF=t(dyF),
                mask=None if mask is None else t(mask),
                dim_names=tuple(dim_names), latlon=bool(latlon),
                periodic_x=bool(periodic_x), bc_y=bc_y)


def equivalent_latitudes(areas: torch.Tensor, Rearth: float = _REARTH):
    """lat_eq from contour-enclosed area: 2*pi*R^2*(sin(latEq)+1) = area,
    clipped into [-1, 1]."""
    ratio = areas / (2.0 * np.pi * Rearth * Rearth) - 1.0
    ratio = torch.clamp(ratio, -1.0, 1.0)
    return torch.rad2deg(torch.arcsin(ratio)).to(areas.dtype)


def latitude_lengths_at(lats: torch.Tensor, Rearth: float = _REARTH):
    """Minimum possible contour length at given latitudes: 2*pi*R*cos(lat)."""
    return (2.0 * np.pi * Rearth * torch.cos(torch.deg2rad(lats))).to(lats.dtype)
