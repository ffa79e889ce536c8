"""Reference-compatible namespace.

Counterpart of ``xcontour_tpu/xcontour.py``.  The reference's tests and
notebooks import everything from ``xcontour.xcontour`` (e.g. its
tests/test_Keff_atmos.py:12); this module provides the same symbols under
the same names so a user of the reference can switch imports and find
everything:

    from xcontour_tpu_torch.xcontour import (
        Contour2D, Table, add_latlon_metrics, add_MITgcm_missing_metrics,
        latitude_lengths_at, equivalent_latitudes,
        contour_length, find_contour, contour_area)

``add_latlon_metrics`` / ``add_MITgcm_missing_metrics`` operate on the plain
dict-of-arrays datasets produced by ``utils.ncio.load_dataset`` (this
framework has no xarray dependency) and return ``(metrics_dict, Grid)``.
The metrics are float64 numpy arrays; the grid is built on ``device``, the
card unless told otherwise (as every grid constructor of the port).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .core import Contour2D, Table  # noqa: F401
from .grid import (Grid, from_latlon, from_metrics, latitude_lengths_at,  # noqa: F401
                   equivalent_latitudes)
from .host.extract import find_contour, contour_length, contour_area  # noqa: F401
from .metrics import (build_latlon_metrics, complete_mitgcm_metrics,  # noqa: F401
                      interp_cgrid, validate_boundary)
from .utils.constants import Rearth as _REARTH
from .utils.constants import Rearth, deg2m, g, omega  # noqa: F401 (reference
# utils.py:19-30 module constants, overridable per-call like the reference)

# reference dim-name autodetect lists (utils.py:34-39)
dimXList = ["lon", "longitude", "LON", "LONGITUDE", "geolon", "GEOLON",
            "xt_ocean", "XC"]
dimYList = ["lat", "latitude", "LAT", "LATITUDE", "geolat", "GEOLAT",
            "yt_ocean", "YC"]
dimZList = ["lev", "level", "LEV", "LEVEL", "pressure", "PRESSURE",
            "depth", "DEPTH", "Z"]


def _detect(ds, dims: Optional[dict]):
    names = set(ds.keys()) if hasattr(ds, "keys") else set(ds)
    if dims is not None:
        return dims.get("X"), dims.get("Y"), dims.get("Z")
    lon = next((d for d in dimXList if d in names), None)
    lat = next((d for d in dimYList if d in names), None)
    lev = next((d for d in dimZList if d in names), None)
    if lon is None or lat is None:
        raise ValueError("unknown dimension names; expected one of "
                         f"{dimXList + dimYList}")
    return lon, lat, lev


def add_latlon_metrics(dset, dims: Optional[dict] = None,
                       boundary: Optional[dict] = None,
                       Rearth: float = _REARTH,
                       dtype=torch.float32, device=None) -> Tuple[dict, Grid]:
    """Infer spherical metrics from 1-D lat/lon coordinates (semantics of
    reference utils.py:43-259): exact cell areas with pole clamping, staggered
    x/y line elements, X-periodicity sniffing.

    Returns (metrics, grid): ``metrics`` maps the reference's names (rA, dxF,
    dyF, dxG, dyG, ...) to numpy arrays, built by the exact staggered
    construction of :func:`xcontour_tpu_torch.metrics.build_latlon_metrics`
    (reference utils.py:118-208); ``grid`` is the :class:`Grid` the analysis
    classes consume.  ``boundary`` ({'X'|'Y'|'Z': 'extend'|'reflect'|'fill'},
    reference utils.py:96-116) is validated and its Y entry selects the wall
    BC of the gradient stencils run on this grid.  ``device`` places the
    grid (None: the card).
    """
    bcs = validate_boundary(boundary)
    lon_n, lat_n, lev_n = _detect(dset, dims)
    lat = np.asarray(dset[lat_n], np.float64)
    lon = np.asarray(dset[lon_n], np.float64)
    grid = from_latlon(lat, lon, Rearth=Rearth, dim_names=(lat_n, lon_n),
                       dtype=dtype, bc_y=bcs["Y"], device=device)
    metrics = build_latlon_metrics(lat, lon, periodic_x=grid.periodic_x,
                                   boundary=boundary, Rearth=Rearth)

    # vertical metrics when a level dimension is present (utils.py:210-221)
    if lev_n is not None and lev_n in dset:
        levC = np.asarray(dset[lev_n], np.float64)
        tmp = np.diff(levC)
        tmp = np.concatenate([[levC[0] - tmp[0]], levC])
        delz = np.diff(tmp)
        metrics["drF"] = delz
        metrics["drG"] = np.concatenate([[delz[0] / 2], delz[1:-1],
                                         [delz[-1] / 2]])
    return metrics, grid


def add_latlon_metrics_old(dset, dims: Optional[dict] = None,
                           boundary: Optional[dict] = None,
                           dtype=torch.float32,
                           device=None) -> Tuple[dict, Grid]:
    """Legacy rectangle-area metrics rA = dyF * dxF (reference
    utils.py:261-415), as numpy copies of the grid's tensors."""
    lon_n, lat_n, _ = _detect(dset, dims)
    lat = np.asarray(dset[lat_n], np.float64)
    lon = np.asarray(dset[lon_n], np.float64)
    grid = from_latlon(lat, lon, dim_names=(lat_n, lon_n), dtype=dtype,
                       exact_area=False, device=device)
    metrics = {k: getattr(grid, f).detach().cpu().numpy()
               for k, f in (("rA", "dA"), ("dxF", "dxF"), ("dyF", "dyF"))}
    return metrics, grid


def add_MITgcm_missing_metrics(dset, periodic="X", boundary=None,
                               partial_cell: bool = True,
                               dtype=torch.float32,
                               device=None) -> Tuple[dict, Grid]:
    """Complete missing MITgcm metrics (reference utils.py:418-488):
    partial-cell thicknesses drW/drS/drC from hFac, the interp-derived
    staggered distances dxF/dyF/dxV/dyU, corner cells hFacZ/maskZ, and the
    X-Z plane area yA = drF * hFacC * dxF — each only when not already in
    ``dset`` (see :func:`xcontour_tpu_torch.metrics.complete_mitgcm_metrics`).

    ``periodic`` names the periodic axes ('X', 'XY', None); ``boundary``
    selects the non-periodic ghost-cell rule for the interpolations;
    ``device`` places the grid (None: the card).

    Returns (metrics, grid): ``metrics`` holds the derived fields; ``grid``
    is on the (Z, XC) vertical plane (for LAPE-style analyses) when ``dset``
    has Z+XC, with dA = yA and partial cells applied.
    """
    get = lambda k: np.asarray(dset[k], np.float64) if k in dset else None
    derived = complete_mitgcm_metrics(dset, periodic=periodic,
                                      boundary=boundary,
                                      partial_cell=partial_cell)
    metrics = dict(derived)

    z = get("Z")
    xc = get("XC")
    per_x = periodic is not None and "X" in periodic
    if z is None:
        # horizontal (YC, XC) C-grid: the reference's ocean-Keff layout
        # (tests/test_Keff_ocean.py); plane metrics come from rA/dxF/dyF
        yc = get("YC")
        if yc is None or xc is None:
            raise ValueError("dset must carry Z+XC or YC+XC coordinates")
        rA = get("rA")
        if rA is None:
            raise ValueError("horizontal MITgcm dset must carry rA")
        dxF = get("dxF")
        if dxF is None:
            dxF = metrics.get("dxF")
        dyF = get("dyF")
        if dyF is None:
            dyF = metrics.get("dyF")
        maskC = get("maskC")
        if maskC is None:
            h = get("hFacC")
            maskC = None if h is None else (h > 0).astype(np.float64)
        if maskC is not None and maskC.ndim > 2:
            maskC = maskC[0]  # surface level masks the analysis plane
        grid = from_metrics(yc, xc, rA, dxF=dxF, dyF=dyF, mask=maskC,
                            dim_names=("YC", "XC"), latlon=True,
                            periodic_x=per_x, dtype=dtype, device=device)
        return metrics, grid
    drF = get("drF")
    dxF = get("dxF")
    if drF is None and ("drC" not in metrics or ("yA" not in dset
                                                 and "yA" not in metrics)):
        raise ValueError("vertical-plane (Z, XC) MITgcm dset must carry drF "
                         "(level thicknesses) unless drC and yA are already "
                         "present")
    if dxF is None:
        dxF = metrics.get("dxF")
    if dxF is None:
        dxF = get("dxC") if "dxC" in dset else get("dxG")
    if dxF is not None and dxF.ndim == 1:
        dxF = np.broadcast_to(dxF[None, :], (z.size, xc.size))
    hFacC = get("hFacC")
    if hFacC is None:
        hFacC = get("maskC")
    if hFacC is None:
        hFacC = np.ones((z.size, xc.size))
    hf = hFacC if partial_cell else np.ones_like(hFacC)

    if "drC" not in metrics:  # hFacC was absent from dset; derive from mask
        metrics["drC"] = hf * (drF[:, None] if drF.ndim == 1 else drF)
    yA = get("yA")
    if yA is None:
        yA = metrics.get("yA")
    if yA is None:
        yA = (drF[:, None] if drF.ndim == 1 else drF) * hf * dxF
    metrics["yA"] = yA

    grid = from_metrics(z, xc, yA, dxF=dxF,
                        mask=(hFacC > 0).astype(np.float64),
                        dim_names=("Z", "XC"), latlon=False,
                        periodic_x=per_x, dtype=dtype, device=device)
    return metrics, grid
