"""Keff and LWA from one sorted state (xcontour notebooks 1.Keff_atmos and
2.LWA_atmos): levels, the area and |grad q|^2 integrals below each level,
equivalent latitudes, Lmin = 2 pi R cos(Y_eq), Leq^2, the normalised Keff,
the sorted profile Q and LWA."""

from __future__ import annotations

import torch

from xcbench.reference import core


def run(q, g, *, N: int, nkeff_mask: float = 2e7) -> dict:
    qy, qx = core.plane_gradient(q, g)
    grdS = qx * qx + qy * qy
    ctr = core.levels(q, N)
    area, grad_int = core.sums_below(q, ctr, [g["dA"], grdS * g["dA"]])
    Yeq = core.equivalent_latitude(area, g)
    Lmin = 2 * torch.pi * core.R_EARTH * torch.cos(Yeq * core.D2R)
    k = core.keff_terms(ctr, area, grad_int, Lmin, nkeff_mask)
    Q = core.profile(g, Yeq, ctr)
    return dict(contour=ctr, intArea=area, intgrdS=grad_int, Yeq=Yeq,
                Lmin=Lmin, Leq2=k["Leq2"], nkeff=k["nkeff"],
                nkeff_raw=k["nkeff_raw"], Q=Q,
                lwa=core.wave_activity(q, Q, g["dA"]))
