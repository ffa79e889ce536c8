"""Sharded windowed contour lengths: gather the field, split the windows.

Counterpart of ``xcontour_tpu/parallel/local_length.py``.  The windowed
workload is compute-bound (windows x window^2 cells) on one (Ny, Nx)
snapshot, so the field is gathered once along x (the one collective
carrying data) and the windows are split over the axis: each rank
measures a block of window rows with K8 on the card
(:func:`..kernels.length.local_lengths` on the rows those windows span),
the window list padded with NaN rows to a multiple of the axis (as JAX
pads it with NaN levels); a second gather joins the blocks, so every rank
returns the whole (Wy, Wx) lengths, as JAX's global output is.  The
window means (the levels) come from ``rolling_mean`` on the gathered field
(R on the card), replicated: recomputing them everywhere is cheaper than
sending them, and every rank gets the unsharded means' bits.  Where an input
needs a gradient, K8 runs through its autograd Function
(:class:`..diagnostics.local_length._LocalLengths`), and the gathers'
backwards return each rank its columns' share of the field's cotangent.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..diagnostics.local_length import (_LocalLengths, _window_centers,
                                        rolling_mean)
from ..kernels import length as _k8
from ..kernels import needs_grad
from ..utils.constants import Rearth as _REARTH
from . import _comm
from .mesh import X, axis_size


def sharded_local_lengths(data: torch.Tensor, ydef: torch.Tensor,
                          xdef: torch.Tensor, mesh: DeviceMesh, *,
                          window: int = 101, stride: int = 10,
                          latlon: bool = True, min_count: int = 1,
                          levels: Optional[torch.Tensor] = None,
                          Rearth: float = _REARTH):
    """Per-window contour length at the window-mean level, the windows
    split over ``mesh``'s 'x' axis.

    data : the rank's (Ny, Nx_local) block of the snapshot; ydef/xdef :
    the whole coordinates.  Returns (lengths (Wy, Wx), window-centre y, x),
    the same on every rank and equal to
    :func:`..diagnostics.local_length.local_contour_lengths`.  The lengths
    are replicated over 'x', so a loss on them counts once per mesh
    (:func:`.mesh.once_per_mesh`); ``levels``' gradient on a rank is its
    share (the shares add up over 'x')."""
    group = mesh.get_group(X)
    nsh, idx = axis_size(mesh, X), mesh.get_local_rank(X)
    d = _comm.all_gather(data, group, dim=1).contiguous()     # (Ny, Nx)
    yc = torch.deg2rad(ydef) if latlon else ydef
    xc = torch.deg2rad(xdef) if latlon else xdef
    yc = yc.to(d.dtype).contiguous()
    xc = xc.to(d.dtype).contiguous()
    means, oy, ox = rolling_mean(d, window, stride, min_count)
    if levels is None:
        levels = means
    Wy, Wx = oy.shape[0], ox.shape[0]
    rows = -(-Wy // nsh)
    r0, r1 = min(Wy, idx * rows), min(Wy, (idx + 1) * rows)
    mine = levels.new_full((rows, Wx), float("nan"))
    if r1 > r0:
        span = slice(r0 * stride, (r1 - 1) * stride + window)
        args = (d[span].contiguous(), levels[r0:r1].contiguous(),
                yc[span].contiguous(), xc)
        kw = dict(window=window, stride=stride, latlon=latlon)
        if needs_grad(*args):
            mine[:r1 - r0] = _LocalLengths.apply(*args, kw)
        else:
            mine[:r1 - r0] = _k8.local_lengths(*args, **kw)
    else:
        # no windows here, but both gathers' backwards run here too
        mine = _comm.keep(mine, group, d, levels)
    totals = _comm.all_gather(mine, group, dim=0)[:Wy]
    lengths = torch.where(torch.isnan(levels) | (totals == 0),
                          torch.full_like(totals, float("nan")), totals)
    if latlon:
        lengths = lengths * Rearth
    cy, cx = _window_centers(ydef, xdef, oy, ox, window)
    return lengths, cy, cx
