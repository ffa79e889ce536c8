"""LAPE on a vertical section (xcontour notebooks/3.LAPE_ocean and
tests/test_LAPE.py): the sorted state along depth and the local wave
activity LWA and LWA2 of a tracer that may decrease along its coordinate,
with partial cells.  LAPE = -LWA.

Written from the definitions, plain PyTorch over :mod:`core`, in any
floating dtype:

- the grid: dA = drF hFacC dx with drF and dx the spacings of the cell
  interfaces halfway between centres (the ends mirrored), fluid where
  hFacC > 0;
- N equally spaced levels from each snapshot's smallest to its largest
  finite value (:func:`core.levels`), largest first for ``increase=False``;
- the area on one side of each level: below it for ``lt`` (q < L, q <= L
  at the top level, :func:`core.sums_below`), else its complement, q >= L
  and none at the top level;
- the area table: the coordinate itself as a tracer over the fluid, on the
  same side of each Z_j by the same rule, the side of the coordinate that
  the tracer's side maps to (the same comparison where the tracer
  increases along the coordinate's values, the other else);
- Z_eq: the coordinate whose table area equals the contour's area; Q:
  the levels placed at their Z_eq, read at the grid's coordinates;
- LWA(j, x) = -sum over i of qe W mask, qe = q(z_i, x) - Q(z_j), and
  LWA2 with qe = q(z_j, x) - Q(z_i) and ``increase`` flipped in the mask,
  with xcontour's weight W = dA dA / max(dA) and its 3-valued mask: +1
  where z_i lies on the far side of z_j (z_i <= z_j for a coordinate that
  decreases along the rows, z_i >= z_j else) and qe has the sign that
  points away from it (qe < 0 for ``increase``, qe > 0 else), -1 where
  z_i lies on the near side (z_i beyond z_j the other way) and qe has the
  other sign, 0 elsewhere; pair by pair, a few surfaces j at a time.

Departures from xcontour: the area table is the histogram table
(``cal_area_eqCoord_table_hist``), which places Z_j's own row inside the
area of every level but the first, where the conditional table
(``cal_area_eqCoord_table``) leaves it out; the benchmark's step builds
the histogram table, so the reference does too.  NaN cells, NaN weights
and NaN profile values add nothing to a sum (xcontour's xarray sums skip
NaN).  It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from xcbench.reference import core

# surface pairs per step of the LWA sums: bounds the (B, chunk, Ny, Nx)
# temporaries
PAIRS_PER_CHUNK = 1 << 27


def xz_grid(z, x, hFacC, dtype, device) -> dict:
    """The section's areas, coordinate and fluid mask."""
    z = np.asarray(z, np.float64)
    x = np.asarray(x, np.float64)
    dz = np.abs(np.diff(core._edges(z)))
    dx = np.abs(np.diff(core._edges(x)))
    h = np.asarray(hFacC, np.float64)
    dA = dz[:, None] * h * dx[None, :]

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64,
                               device=device).to(dtype)
    return dict(z=t(z), dA=t(dA), fluid=torch.as_tensor(h > 0, device=device))


def side_areas(q: torch.Tensor, lev: torch.Tensor, w: torch.Tensor,
               lt: bool) -> torch.Tensor:
    """The sum of ``w`` on one side of each level (module docstring);
    ``lev`` ascending or descending, the same for every row."""
    desc = bool(lev[0, -1] < lev[0, 0])
    asc = lev.flip(-1) if desc else lev
    (below,) = core.sums_below(q, asc, [w])
    out = below if lt else below[:, -1:] - below
    return out.flip(-1) if desc else out


def _ascending(xp, fp):
    """(xp, fp) reversed along the last axis where xp descends."""
    flip = (xp[..., -1:] < xp[..., :1])
    return (torch.where(flip, xp.flip(-1), xp),
            torch.where(flip, fp.flip(-1), fp))


def table(g: dict, increase: bool, lt: bool) -> torch.Tensor:
    z = g["z"]
    field = torch.where(g["fluid"], z[:, None], torch.nan)[None]
    same = bool(z[-1] > z[0]) == increase
    return side_areas(field, z[None], g["dA"], lt if same else not lt)


def wave_activity(q, Q, g, increase: bool, variant2: bool):
    """LWA (``variant2``: LWA2) by pairs (module docstring)."""
    z, dA = g["z"], g["dA"]
    W = dA * dA / dA.max()
    B, Ny, Nx = q.shape
    inc = increase != variant2
    down = bool(z[-1] < z[0])
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    one = torch.ones((), dtype=q.dtype, device=q.device)
    step = max(1, PAIRS_PER_CHUNK // (B * Ny * Nx))
    rows = []
    for j0 in range(0, Ny, step):
        js = torch.arange(j0, min(Ny, j0 + step), device=q.device)
        zj = z[js][:, None]
        far = (z[None, :] <= zj) if down else (z[None, :] >= zj)
        far = far[None, :, :, None]                      # (1, c, Ny, 1)
        if variant2:
            qe = q[:, js, None, :] - Q[:, None, :, None]
        else:
            qe = q[:, None] - Q[:, js, None, None]       # (B, c, Ny, Nx)
        away, toward = (qe < 0, qe > 0) if inc else (qe > 0, qe < 0)
        mask = torch.where(far, torch.where(away, one, zero),
                           torch.where(toward, -one, zero))
        rows.append(-torch.nan_to_num(qe * mask * W, nan=0.0).sum(2))
    return torch.cat(rows, dim=1)


def run(q, g, *, N: int, increase: bool = False, lt: bool = False) -> dict:
    ctr = core.levels(q, N)
    ctr = ctr if increase else ctr.flip(-1)
    area = side_areas(q, ctr, g["dA"], lt)
    Zeq = core.interp(area, *_ascending(table(g, increase, lt)[0], g["z"]))
    Q = core.interp(g["z"], *_ascending(Zeq, ctr))
    return dict(contour=ctr, intArea=area, latEq=Zeq, Q=Q,
                lwa=wave_activity(q, Q, g, increase, False),
                lwa2=wave_activity(q, Q, g, increase, True))
