"""Contour lengths beside the Keff algebra (xcontour tests/test_clength.py):
perimeters by marching squares, Lmin as the zonal length at Y_eq, Leq^2,
the normalised Keff, and the contour means of |grad q| and 1/|grad q|
(Cauchy-Schwarz: <|grad q|^2>/<|grad q|> and <1>/<|grad q|> along each
contour, each a d/dA of integrals below the levels)."""

from __future__ import annotations

import torch

from xcbench.reference import core


def run(q, g, *, N: int, nkeff_mask: float = 1e5) -> dict:
    dA = g["dA"]
    qy, qx = core.plane_gradient(q, g)
    grdS = qx * qx + qy * qy
    grdm = torch.sqrt(grdS)
    ctr = core.levels(q, N)
    area, grad_int, int_gg, int_g, int_ig = core.sums_below(
        q, ctr, [dA, grdS * dA, grdm * grdm * dA, grdm * dA,
                 (1 / grdm) * grdm * dA])
    Yeq = core.equivalent_latitude(area, g)
    zonal = 2 * torch.pi * core.R_EARTH * torch.cos(g["lat"] * core.D2R)
    Lmin = core.interp(Yeq, g["lat"], zonal)
    k = core.keff_terms(ctr, area, grad_int, Lmin, nkeff_mask)
    dAr = core.index_gradient(area)
    lower = core.index_gradient(int_g) / dAr
    return dict(contour=ctr, intArea=area, Yeq=Yeq,
                lengths=core.contour_lengths(q, ctr, g["lat"], g["lon"],
                                             latlon=True),
                Lmin=Lmin, Leq2=k["Leq2"], nkeff=k["nkeff"],
                nkeff_raw=k["nkeff_raw"],
                cmGrd=core.index_gradient(int_gg) / dAr / lower,
                cmInvGrd=core.index_gradient(int_ig) / dAr / lower)
