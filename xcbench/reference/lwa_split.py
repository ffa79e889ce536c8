"""LWA split into its two halves (Huang and Nakamura 2016; xcontour's
3-valued mask, core.py:759-784) on a latitude-longitude grid, for a
tracer increasing in y: the sorted state of :mod:`core` (levels, the area
below each level, equivalent latitudes, the profile Q), then, pair by
pair, a few surfaces j at a time,

    upper(j, x) (W+) = -sum over y >= y_j of qe W  where qe < 0,
    lower(j, x) (W-) =  sum over y <  y_j of qe W  where qe > 0,

with qe = q(y, x) - Q_j and xcontour's weight W = dA dA / max(dA): the
mask's +1 side and its -1 side, so upper + lower is
:func:`core.wave_activity`.  LWA2 takes qe = q(y_j, x) - Q(y) with the
mask's direction flipped (as :mod:`lape` does): upper keeps its +1 side
(y >= y_j, qe > 0), lower its -1 side (y < y_j, qe < 0).  NaN cells and
NaN profile values add nothing.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

from xcbench.reference import core

# surface pairs per step of the sums: bounds the (B, chunk, Ny, Nx)
# temporaries
PAIRS_PER_CHUNK = 1 << 27


def halves(q: torch.Tensor, Q: torch.Tensor, W: torch.Tensor, *,
           increase: bool = True, variant2: bool = False):
    """(upper, lower), each (B, Ny, Nx), of LWA (``variant2``: LWA2) for
    q (B, Ny, Nx) on ascending y, Q (B, Ny) and W (Ny, Nx).  The mask's +1
    side is y >= y_j where qe points away from the contour (qe < 0 for an
    increasing tracer, qe > 0 else; ``variant2`` flips the direction), its
    -1 side y < y_j where qe points toward it; upper keeps the +1 side for
    ``increase`` and the -1 side else, lower the other."""
    B, Ny, Nx = q.shape
    iy = torch.arange(Ny, device=q.device)
    inc = increase != variant2
    step = max(1, PAIRS_PER_CHUNK // (B * Ny * Nx))
    plus_rows, minus_rows = [], []
    for j0 in range(0, Ny, step):
        js = torch.arange(j0, min(Ny, j0 + step), device=q.device)
        if variant2:
            qe = q[:, js, None, :] - Q[:, None, :, None]   # (B, c, Ny, Nx)
        else:
            qe = q[:, None] - Q[:, js, None, None]
        far = (iy[None, :] >= js[:, None])[None, :, :, None]
        away, toward = (qe < 0, qe > 0) if inc else (qe > 0, qe < 0)
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        # -qe * mask * W with mask +1 on the far side, -1 on the near side
        plus = torch.where(far & away, -qe, zero) * W
        minus = torch.where(~far & toward, qe, zero) * W
        plus_rows.append(torch.nan_to_num(plus, nan=0.0).sum(2))
        minus_rows.append(torch.nan_to_num(minus, nan=0.0).sum(2))
    plus, minus = torch.cat(plus_rows, 1), torch.cat(minus_rows, 1)
    return (plus, minus) if increase else (minus, plus)


def run(q, g, *, N: int) -> dict:
    ctr = core.levels(q, N)
    (area,) = core.sums_below(q, ctr, [g["dA"]])
    latEq = core.equivalent_latitude(area, g)
    Q = core.profile(g, latEq, ctr)
    W = g["dA"] / g["dA"].max() * g["dA"]
    lwa_upper, lwa_lower = halves(q, Q, W)
    lwa2_upper, lwa2_lower = halves(q, Q, W, variant2=True)
    return dict(contour=ctr, intArea=area, latEq=latEq, Q=Q,
                lwa_upper=lwa_upper, lwa_lower=lwa_lower,
                lwa2_upper=lwa2_upper, lwa2_lower=lwa2_lower)
