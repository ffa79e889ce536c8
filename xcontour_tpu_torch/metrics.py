"""Staggered C-grid metric construction (L1).

A copy of ``xcontour_tpu/metrics.py`` (plain NumPy, no JAX), kept in the
port so that it imports nothing of the JAX package.  Numerically exact
re-implementation of the reference metric constructors:

* ``build_latlon_metrics`` — the staggered-distance + exact spherical-area
  construction of ``add_latlon_metrics`` (reference xcontour/utils.py:43-259):
  center/left coordinate diffs with the reference's periodic-wrap and
  zero-endpoint fixes, ``__dll_dist`` pole clamping (utils.py:615-646), the
  four interpolated distances dxF/dyF/dxV/dyU (utils.py:169-172), and the
  edge-latitude areas rA/rAw/rAs/rAz (utils.py:179-208).
* ``complete_mitgcm_metrics`` — ``add_MITgcm_missing_metrics``
  (utils.py:418-488): partial-cell thicknesses drW/drS/drC, the staggered
  interpolations dxF<-interp(dxC,'X'), dyF<-interp(dyC,'Y'),
  dxV<-interp(dxG,'X'), dyU<-interp(dyG,'Y'), hFacZ<-interp(hFacS,'X'),
  maskZ=hFacZ, and the X-Z plane area yA.

The reference delegates staggered-position bookkeeping to xgcm; here the
stagger of every field is stated explicitly (MITgcm conventions) and the
two-point interpolation is :func:`interp_cgrid`.  All math is NumPy float64 —
metric construction is host-side setup, not device compute.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .utils.constants import Rearth as _REARTH

_D2R = np.pi / 180.0

#: boundary-condition values accepted by the metric constructors: 'extend'
#: replicates the edge value (xgcm 'extend'), 'fill' uses zero ghosts
#: (xgcm 'fill'), and for the Y axis of the gradient stencil 'reflect'
#: selects the zero-normal-gradient wall (ops/stencil.py).
VALID_BOUNDARY = ("extend", "fill", "reflect")


def validate_boundary(boundary: Optional[dict]) -> dict:
    """Normalize/validate a reference-style ``boundary`` dict
    ({'X'|'Y'|'Z': bc}); unknown axes or BC names raise (the reference
    silently threads them into xgcm, utils.py:96-101 — here unsupported
    values fail loudly instead of being discarded)."""
    out = {"X": "extend", "Y": "extend", "Z": "extend"}
    if boundary is None:
        return out
    for ax, bc in boundary.items():
        if ax not in out:
            raise ValueError(f"unknown boundary axis {ax!r}; expected X/Y/Z")
        if bc not in VALID_BOUNDARY:
            raise ValueError(
                f"unsupported boundary {bc!r} for axis {ax!r}; "
                f"supported: {VALID_BOUNDARY}")
        out[ax] = bc
    return out


def interp_cgrid(arr, axis: int, frm: str, periodic: bool = False,
                 bc: str = "extend") -> np.ndarray:
    """Two-point C-grid interpolation between staggered positions along
    ``axis`` (xgcm ``Grid.interp`` semantics for same-length axes).

    ``frm='left'``  : values at left/lower faces -> cell centers,
                      out[i] = (f[i] + f[i+1]) / 2.
    ``frm='center'``: values at centers -> left/lower faces,
                      out[i] = (f[i-1] + f[i]) / 2.

    The ghost point past the boundary wraps when ``periodic``, replicates the
    edge for ``bc='extend'``, and is zero for ``bc='fill'``.
    """
    a = np.asarray(arr, np.float64)
    if frm not in ("left", "center"):
        raise ValueError(f"frm must be 'left' or 'center', got {frm!r}")
    if bc not in ("extend", "fill"):
        raise ValueError(f"interp_cgrid supports extend/fill BCs, got {bc!r}")
    shift = -1 if frm == "left" else 1
    other = np.roll(a, shift, axis=axis)
    if not periodic:
        edge = [slice(None)] * a.ndim
        edge[axis] = slice(-1, None) if frm == "left" else slice(0, 1)
        edge = tuple(edge)
        ghost = a[edge] if bc == "extend" else np.zeros_like(a[edge])
        other[edge] = ghost
    return 0.5 * (a + other)


def _fix_zero_endpoints(d: np.ndarray) -> np.ndarray:
    """The reference's non-periodic endpoint adjustment (utils.py:143-162,
    'mini-dong'): a zero produced by the boundary diff is replaced by the
    SECOND element — an if/elif, so only one end is fixed per call."""
    d = d.copy()
    if d[0] == 0:
        d[0] = d[1]
    elif d[-1] == 0:
        d[-1] = d[1]
    return d


def _wrap_terminal_lon(d: np.ndarray) -> np.ndarray:
    """Periodic terminal-point adjustment (utils.py:129-138): fold the two
    end diffs back into [0, 360]."""
    d = d.copy()
    for i in (0, -1):
        if d[i] < 0:
            d[i] += 360.0
        elif d[i] > 360.0:
            d[i] -= 360.0
    return d


def _diff_center_to_left(c: np.ndarray, periodic: bool) -> np.ndarray:
    """d[i] = c[i] - c[i-1] at left positions; periodic wraps, non-periodic
    leaves 0 at i=0 for :func:`_fix_zero_endpoints` (xgcm diff + reference
    endpoint handling, utils.py:125-152)."""
    d = c - np.roll(c, 1)
    if not periodic:
        d[0] = 0.0
        return _fix_zero_endpoints(d)
    return _wrap_terminal_lon(d) if c.size else d


def _diff_left_to_center(g: np.ndarray, periodic: bool) -> np.ndarray:
    """d[i] = g[i+1] - g[i] at center positions (diff of a left-positioned
    coordinate); the missing last value is 0 then endpoint-fixed."""
    d = np.roll(g, -1) - g
    if not periodic:
        d[-1] = 0.0
        return _fix_zero_endpoints(d)
    return _wrap_terminal_lon(d) if g.size else d


def _left_positions(c: np.ndarray) -> np.ndarray:
    """xgcm.autogenerate 'left' positions: interior midpoints, first edge
    extrapolated by half the boundary spacing (utils.py:119-122)."""
    g = np.empty_like(c)
    g[1:] = 0.5 * (c[:-1] + c[1:])
    g[0] = c[0] - 0.5 * (c[1] - c[0])
    return g


def _dll_dist(dlon, dlat, lat, Rearth: float):
    """Reference ``__dll_dist`` (utils.py:615-646): degrees -> meters with
    |cos| pole clamping and the 1e-15 threshold."""
    degtom = 2.0 * np.pi * Rearth / 360.0
    dx = np.cos(np.deg2rad(lat)) * dlon * degtom
    dx = np.abs(dx)
    dx = np.where(dx < 1e-15, 0.0, dx)
    dy = dlat * degtom
    return dx, dy


def _clamped_band(phi1: np.ndarray, phi2: np.ndarray) -> np.ndarray:
    """|sin(phi1) - sin(phi2)| with the reference's conditional pole clamp
    (utils.py:184-189 / 199-204): clamp only when the second/second-to-last
    entries are strictly inside +/-90."""
    t1, t2 = phi1, phi2
    if abs(phi1[1]) < 90 and abs(phi1[-2]) < 90:
        t1 = np.where(phi1 > 90.0, 90.0, phi1)
    if abs(phi2[1]) < 90 and abs(phi2[-2]) < 90:
        t2 = np.where(phi2 < -90.0, -90.0, phi2)
    return np.abs(np.sin(t1 * _D2R) - np.sin(t2 * _D2R))


def build_latlon_metrics(lat, lon, periodic_x: bool,
                         boundary: Optional[dict] = None,
                         Rearth: float = _REARTH) -> Dict[str, np.ndarray]:
    """Full staggered metric set from 1-D center lat/lon (degrees), exactly
    the construction of reference utils.py:118-208.

    Returns (Ny, Nx) float64 arrays keyed by the reference names.  Stagger of
    each output (reference dims): dxG (YG, XC), dyG (YC, XG), dxC (YC, XG),
    dyC (YG, XC), dxF/dyF/rA (YC, XC), dxV/rAz (YG, XG), dyU (YG, XG),
    rAw (YC, XG), rAs (YG, XC) — all same-shape arrays here, position encoded
    by construction.
    """
    bcs = validate_boundary(boundary)
    latC = np.asarray(lat, np.float64)
    lonC = np.asarray(lon, np.float64)
    latG = _left_positions(latC)
    lonG = _left_positions(lonC)

    # coordinate differentials (utils.py:125-162)
    dlonC = _diff_center_to_left(lonC, periodic_x)   # at XG
    dlonG = _diff_left_to_center(lonG, periodic_x)   # at XC (cell widths)
    dlatC = _diff_center_to_left(latC, False)        # at YG
    dlatG = _diff_left_to_center(latG, False)        # at YC (cell heights)

    # staggered distances (utils.py:166-167): dxG pairs dlonG with latG,
    # dxC pairs dlonC with latC; dy* broadcast along the paired lon axis
    Ny, Nx = latC.size, lonC.size
    dxG, dyGv = _dll_dist(dlonG[None, :], dlatG, latG[:, None], Rearth)
    dxC, dyCv = _dll_dist(dlonC[None, :], dlatC, latC[:, None], Rearth)
    dyG = np.broadcast_to(dyGv[:, None], (Ny, Nx)).copy()   # (YC, XG)
    dyC = np.broadcast_to(dyCv[:, None], (Ny, Nx)).copy()   # (YG, XC)

    # interpolated distances (utils.py:169-172)
    dxF = interp_cgrid(dxG, 0, "left", periodic=False, bc=_interp_bc(bcs["Y"]))
    dyF = interp_cgrid(dyG, 1, "left", periodic=periodic_x,
                       bc=_interp_bc(bcs["X"]))
    dxV = interp_cgrid(dxG, 1, "center", periodic=periodic_x,
                       bc=_interp_bc(bcs["X"]))
    dyU = interp_cgrid(dyG, 0, "center", periodic=False,
                       bc=_interp_bc(bcs["Y"]))

    # exact spherical areas S = R^2 |sin(phi1)-sin(phi2)| dlambda
    # (utils.py:179-208).  Center rows: band between cell edges.
    R2 = Rearth * Rearth
    band_c = _clamped_band(latG + dlatG, latG)       # (Ny,) at YC
    rA = R2 * band_c[:, None] * (dlonG * _D2R)[None, :]
    rAw = R2 * band_c[:, None] * (dlonC * _D2R)[None, :]
    # edge rows: band between adjacent centers (utils.py:196-207)
    band_g = _clamped_band(latC, latC - dlatC)       # (Ny,) at YG
    rAs = R2 * band_g[:, None] * (dlonG * _D2R)[None, :]
    rAz = R2 * band_g[:, None] * (dlonC * _D2R)[None, :]

    return {"rA": rA, "rAw": rAw, "rAs": rAs, "rAz": rAz,
            "dxG": dxG, "dxF": dxF, "dxC": dxC, "dxV": dxV,
            "dyG": dyG, "dyF": dyF, "dyC": dyC, "dyU": dyU}


def _interp_bc(bc: str) -> str:
    # 'reflect' is a stencil-only BC; for metric interpolation it behaves
    # like 'extend' (the ghost metric equals the wall metric)
    return "extend" if bc == "reflect" else bc


def complete_mitgcm_metrics(dset, periodic: Optional[str] = "X",
                            boundary: Optional[dict] = None,
                            partial_cell: bool = True
                            ) -> Dict[str, np.ndarray]:
    """Derive the metrics MITgcm output files omit (reference
    utils.py:418-488), on a dict-of-arrays dataset.

    Inputs follow MITgcm stagger conventions: dxC (YC, XG), dyC (YG, XC),
    dxG (YG, XC), dyG (YC, XG), hFac[C|W|S] ([Z,] Y, X), drF (Z,).
    Derived, each only when absent from ``dset``:

    * drW/drS/drC = hFac[W|S|C] * drF (partial cells; utils.py:444-449)
    * dxF = interp(dxC, 'X'), dyF = interp(dyC, 'Y'),
      dxV = interp(dxG, 'X'), dyU = interp(dyG, 'Y') (utils.py:453-460)
    * hFacZ = interp(hFacS, 'X'), maskZ = hFacZ (utils.py:462-465)
    * yA = drF * hFacC * dxF (utils.py:467-469)
    """
    bcs = validate_boundary(boundary)
    per_x = periodic is not None and "X" in periodic
    per_y = periodic is not None and "Y" in periodic

    def get(k):
        return np.asarray(dset[k], np.float64) if k in dset else None

    out: Dict[str, np.ndarray] = {}
    drF = get("drF")
    hFacC, hFacW, hFacS = get("hFacC"), get("hFacW"), get("hFacS")

    def _dr(h):
        if drF is None or h is None:
            return None
        dr = drF.reshape(drF.shape + (1,) * (h.ndim - drF.ndim))
        return h * dr if partial_cell else np.broadcast_to(dr, h.shape).copy()

    for name, h in (("drW", hFacW), ("drS", hFacS), ("drC", hFacC)):
        if name not in dset:
            v = _dr(h)
            if v is not None:
                out[name] = v

    # staggered horizontal distances by interpolation; X axis may be
    # periodic, Y is a wall (boundary-selected ghost)
    def _interp(src, axis_name, frm):
        arr = get(src)
        if arr is None or arr.ndim < 2:
            return arr
        axis = -1 if axis_name == "X" else -2
        per = per_x if axis_name == "X" else per_y
        return interp_cgrid(arr, axis, frm, periodic=per,
                            bc=_interp_bc(bcs[axis_name]))

    if "dxF" not in dset:
        v = _interp("dxC", "X", "left")     # (YC, XG) -> (YC, XC)
        if v is not None:
            out["dxF"] = v
    if "dyF" not in dset:
        v = _interp("dyC", "Y", "left")     # (YG, XC) -> (YC, XC)
        if v is not None:
            out["dyF"] = v
    if "dxV" not in dset:
        v = _interp("dxG", "X", "center")   # (YG, XC) -> (YG, XG)
        if v is not None:
            out["dxV"] = v
    if "dyU" not in dset:
        v = _interp("dyG", "Y", "center")   # (YC, XG) -> (YG, XG)
        if v is not None:
            out["dyU"] = v

    if "hFacZ" not in dset and hFacS is not None:
        out["hFacZ"] = interp_cgrid(hFacS, -1, "center", periodic=per_x,
                                    bc=_interp_bc(bcs["X"]))
    if "maskZ" not in dset:
        hz = out.get("hFacZ", get("hFacZ"))
        if hz is not None:
            out["maskZ"] = hz

    if "yA" not in dset and drF is not None:
        dxFv = get("dxF")
        if dxFv is None:
            dxFv = out.get("dxF")
        if dxFv is not None:
            # maskC stands in for hFacC when only the binary mask exists
            # (cells are then fully fluid or fully land) — otherwise land
            # cells would get nonzero plane area (reference utils.py:467-469
            # always has hFacC; the facade documents this fallback)
            hfc = hFacC if hFacC is not None else get("maskC")
            hf = hfc if (partial_cell and hfc is not None) else 1.0
            # drF(Z) broadcasts against hFacC(Z,[Y,]X); without hFac, an X-Z
            # plane dxF(Z,X) already leads with Z, a horizontal dxF(Y,X)
            # gains a Z axis (yA is (Z,Y,X) then)
            if isinstance(hf, np.ndarray):
                nd = hf.ndim
            elif dxFv.ndim >= 2 and dxFv.shape[0] == drF.shape[0]:
                nd = dxFv.ndim
            else:
                nd = dxFv.ndim + 1
            dr = drF.reshape(drF.shape + (1,) * (nd - drF.ndim))
            out["yA"] = dr * hf * dxFv
    return out
