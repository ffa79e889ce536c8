"""Fractal dimension of contours (xcontour's contour-length scaling):
perimeters on a ladder of block-mean coarsenings, box-counting lengths,
rulers s * cos(Y_eq) * dlon * R, and the log-log slopes D and D_bc."""

from __future__ import annotations

import torch

from xcbench.reference import core


def run(q, g, *, N: int, strides) -> dict:
    strides = [int(s) for s in strides]
    ctr = core.levels(q, N)
    (area,) = core.sums_below(q, ctr, [g["dA"]])
    Yeq = core.equivalent_latitude(area, g)
    lat, lon = g["lat"], g["lon"]
    L = []
    for s in strides:
        ys = lat if s == 1 else lat.reshape(-1, s).mean(1)
        xs = lon if s == 1 else lon.reshape(-1, s).mean(1)
        L.append(core.contour_lengths(core.block_mean(q, s), ctr, ys, xs,
                                      latlon=True))
    L = torch.stack(L, -1)
    rulers = (torch.as_tensor(strides, dtype=q.dtype, device=q.device)
              * torch.cos(Yeq * core.D2R)[..., None]
              * (g["reso"] * core.D2R * core.R_EARTH))
    bc = core.box_lengths(q, ctr, g["dA"], strides)
    return dict(contour=ctr, intArea=area, Yeq=Yeq, lengths=L,
                rulers=rulers, D=core.loglog_dimension(L, rulers),
                bclens=bc, D_bc=core.loglog_dimension(bc, rulers))
