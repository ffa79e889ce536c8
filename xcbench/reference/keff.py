"""The effective-diffusivity chain alone (xcontour notebook 1.Keff_atmos,
the ``keff`` command's outputs): levels, the area and |grad q|^2 integrals
below each level, equivalent latitudes, their d/dA, Leq^2, Lmin = 2 pi R
cos(Y_eq) and the normalised Keff."""

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
    return dict(contour=ctr, intArea=area, intgrdS=grad_int, Yeq=Yeq,
                dgrdSdA=k["dgrdSdA"], dqdA=k["dqdA"], Leq2=k["Leq2"],
                Lmin=Lmin, nkeff=k["nkeff"], nkeff_raw=k["nkeff_raw"])
