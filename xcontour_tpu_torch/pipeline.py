"""The flagship combined Keff + LWA step.

Counterpart of ``keff_lwa_pipeline`` in ``xcontour_tpu/pipeline.py``: the
full effective-diffusivity chain and the local wave activity from one shared
sorted state (table, contours and areas computed once), over a batch of
(..., Ny, Nx) snapshots.  It runs eagerly; the JAX version's static flags
are plain Python arguments.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import core
from .diagnostics import lwa as _lwa
from .grid import Grid, latitude_lengths_at
from .ops.histogram import weighted_cdf_multi
from .ops.interp import interp1d
from .ops.stencil import squared_gradient


def keff_lwa_pipeline(tracer: torch.Tensor, grid: Grid,
                      grdS: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None,
                      pre_y: Optional[torch.Tensor] = None, *, N: int = 121,
                      increase: bool = True, lt: bool = True,
                      lmin: str = "analytic", metric: str = "dA",
                      with_lwa2: bool = False, lwa_method: str = "auto",
                      table: Optional[core.Table] = None) -> dict:
    """Keff chain + LWA on (..., Ny, Nx) snapshots.

    lmin : 'analytic' — 2*pi*R*cos(Yeq);
           'dxF'      — masked zonal sum of dxF interpolated to Yeq;
           'frac'     — latitude_lengths_at(lat) * zonal fluid fraction.
    metric : LWA weight, 'dA' (wei*dA) or 'dy' (wei*dyF).
    table : a precomputed A(Y_eq) table.  It depends only on (mask, ydef,
        dA), so a loop over many snapshots builds it once with
        core.cal_area_eqCoord_table_hist and passes it in.
    pre_y : optional coordinates to interpolate Leq2, nkeff, Lmin onto
        (``*_at`` keys).

    Returns a dict with contour, intArea, intgrdS, Yeq, Lmin, Leq2, nkeff,
    Q and lwa.
    """
    if with_lwa2:
        raise NotImplementedError(
            "with_lwa2 needs the LWA2 kernel (K5), which is not ported yet "
            "(ROADMAP Queue 1 item 10)")
    if lmin not in ("analytic", "dxF", "frac"):
        raise ValueError(f"unknown lmin mode {lmin!r}")
    if metric not in ("dA", "dy"):
        raise ValueError(f"unknown LWA metric {metric!r}")
    dtype = tracer.dtype
    ydef = grid.ydef.to(dtype)
    dA = grid.dA.to(dtype)
    if mask is None:
        mask = grid.fluid_mask(dtype)
    if grdS is None:
        grdS = squared_gradient(tracer, grid)

    if table is None:
        table = core.cal_area_eqCoord_table_hist(mask, ydef, dA,
                                                 increase=increase, lt=lt)
    ctr = core.cal_contours(tracer, N, increase=increase)
    # the area and |grad q|^2 integrals share one digitize pass
    intArea, intgrdS = weighted_cdf_multi(tracer, ctr, [dA, grdS * dA], lt)
    Yeq = table.lookup_coordinates(intArea)

    if lmin == "analytic":
        Lmin = latitude_lengths_at(Yeq)
    elif lmin == "dxF":
        pre_lmin = torch.sum(mask * grid.dxF.to(dtype), dim=-1)
        Lmin = interp1d(Yeq, ydef, pre_lmin, increasing=ydef[-1] > ydef[0])
    else:
        lat_len = latitude_lengths_at(ydef)
        frac = torch.sum(mask, dim=-1) / mask.shape[-1]
        Lmin = interp1d(Yeq, ydef, frac * lat_len,
                        increasing=ydef[-1] > ydef[0])

    dgrdSdA = core.cal_gradient_wrt_area(intgrdS, intArea)
    dqdA = core.cal_gradient_wrt_area(ctr, intArea)
    Leq2 = core.cal_sqared_equivalent_length(dgrdSdA, dqdA)
    nkeff = core.cal_normalized_Keff(Leq2, Lmin, 2e7)

    Q = core.interp_to_coords(ydef, Yeq, ctr)
    weight = (dA / _lwa.nanmax(dA) * grid.dyF.to(dtype)
              if metric == "dy" else None)
    lwa = _lwa.local_wave_activity(tracer, Q, dA, ydef, increase=increase,
                                   part="all", weight=weight,
                                   method=lwa_method)
    out = dict(contour=ctr, intArea=intArea, intgrdS=intgrdS, Yeq=Yeq,
               Lmin=Lmin, Leq2=Leq2, nkeff=nkeff, Q=Q, lwa=lwa)
    if pre_y is not None:
        pre_y = pre_y.to(dtype)
        for k in ("Leq2", "nkeff", "Lmin"):
            out[k + "_at"] = core.interp_to_coords(pre_y, Yeq, out[k])
    return out
