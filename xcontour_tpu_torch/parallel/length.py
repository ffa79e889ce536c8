"""Sharded contour perimeters: one halo column, the slab's cells, a sum
over 'x'.

Counterpart of ``xcontour_tpu/parallel/length.py``.  Marching-squares
cells are local except at a slab's right edge, where a cell spans the
slab's last column and the right neighbour's first: each rank fetches that
one column over the ring, measures its own cells with K7's raw totals
(:func:`..kernels.length.contour_lengths`: the plain version on the CPU),
and a sum all-reduce of the (B, N) totals finishes the reduction.  The
global cell set is columns 0..Nx-2, with no periodic seam cell (as on one
card and in skimage): the last rank's wrapped halo is set to NaN, so its
phantom seam cells vanish by the NaN rule.  The exact-empty rule
(``== 0`` -> NaN) and ``Rearth`` come once, after the sum.  Where an
input needs a gradient, K7 runs through its autograd Function
(:class:`..diagnostics.length._ContourLengths`); the halo column's
cotangent goes back to the right neighbour through the shift's backward,
and the last rank's NaN halo carries none.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..diagnostics.length import _ContourLengths
from ..kernels import length as _k7
from ..kernels import needs_grad
from ..utils.constants import Rearth as _REARTH
from . import _comm
from .mesh import X, axis_size


def sharded_contour_lengths(data: torch.Tensor, contours: torch.Tensor,
                            ydef: torch.Tensor, xdef: torch.Tensor,
                            mesh: DeviceMesh, *, latlon: bool = False,
                            Rearth: float = _REARTH) -> torch.Tensor:
    """Perimeter of each contour level with the grid X axis sharded.

    data : the rank's (B_local, Ny, Nx_local) block; contours :
    (B_local, N) or (N,), replicated over 'x'; ydef/xdef : the whole
    coordinate vectors (degrees if latlon).  Returns (B_local, N),
    replicated over 'x', equal to
    :func:`..diagnostics.length.contour_lengths` of the whole grid.
    ``contours``' gradient on a rank is its slab's share (the shares add
    up over 'x')."""
    B, Ny, nxl = data.shape
    nsh, idx = axis_size(mesh, X), mesh.get_local_rank(X)
    Nx = xdef.shape[-1]
    if Nx != nxl * nsh:
        raise ValueError(f"X axis must divide evenly across the mesh: "
                         f"Nx={Nx}, {nsh} shards of {nxl}")
    yc = torch.deg2rad(ydef) if latlon else ydef
    xc = torch.deg2rad(xdef) if latlon else xdef
    yc = yc.to(data.dtype).contiguous()
    xc = xc.to(data.dtype)
    ctr = torch.broadcast_to(contours, (B, contours.shape[-1])).contiguous()
    # the right neighbour's first column; the last rank's wraps round the
    # seam, so it is NaN: the seam cells do not exist
    group = mesh.get_group(X)
    halo = _comm.shift(data[..., :1], group, -1)
    if idx == nsh - 1:
        # no cotangent, but the shift's backward runs here too
        halo = _comm.keep(torch.full_like(halo, float("nan")), group, halo)
    ext = torch.cat([data, halo], dim=-1).contiguous()
    # one wrap column keeps the last rank's coordinate slice in bounds
    xl = torch.cat([xc, xc[:1]])[idx * nxl: idx * nxl + nxl + 1].contiguous()
    if needs_grad(ext, ctr, yc, xl):
        # 8 levels a chunk in the backward, the wrapper's default
        totals = _ContourLengths.apply(ext, ctr, yc, xl, latlon, 8)
    else:
        totals = _k7.contour_lengths(ext, ctr, yc, xl, latlon=latlon)
    totals = _comm.sum_(totals, mesh.get_group(X))
    totals = torch.where(totals == 0, torch.full_like(totals, float("nan")),
                         totals)
    return totals * Rearth if latlon else totals
