"""Halo exchange for the finite differences of an x-sharded grid.

Counterpart of ``xcontour_tpu/parallel/stencil.py``.  The centred
difference at a slab's edge needs each neighbour's edge column: one ring
shift a direction (the JAX module's ``lax.ppermute``) of a single
(B, Ny, 1) column.  The slab, extended by the columns it received, then
takes the unsharded stencil with non-periodic x: the interior of a
non-periodic difference is the periodic formula, operation for
operation, and where the global grid is not periodic the first and last
rank add no halo on their outer side, so their edge columns get the
one-sided difference of the global edges.  :func:`sharded_squared_gradient`
runs K1 on the extended slab (on the card; its plain version on the CPU),
so each cell gets the same bits as the unsharded K1, through K1's
autograd Function (:class:`..ops.stencil._SquaredGradient`) where ``q``
needs a gradient; :func:`sharded_gradient` (for ``clength``) the plain
differences of ``ops.stencil.gradient``.  The y boundary is the grid's
``bc_y``, as unsharded.  A halo column's cotangent goes back to the
neighbour that sent it through the shift's backward.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..grid import Grid
from ..kernels import needs_grad
from ..kernels import stencil as _k1
from ..kernels.stencil import _centered_x, _centered_y
from ..ops.stencil import _SquaredGradient, _spacing
from . import _comm
from .mesh import X, axis_size


def _halo(q: torch.Tensor, grid: Grid, mesh: DeviceMesh):
    """(the slab extended by its neighbours' edge columns, the global
    columns it spans, the slice of the slab's own columns in it)."""
    nsh, idx = axis_size(mesh, X), mesh.get_local_rank(X)
    nxl = q.shape[-1]
    if not grid.periodic_x and nxl < 2:
        raise ValueError(
            f"non-periodic sharded stencil needs >= 2 columns per shard; "
            f"Nx={nxl * nsh} over {nsh} shards gives {nxl}")
    group = mesh.get_group(X)
    # every rank takes part in both shifts, whether or not it keeps a halo
    from_left = _comm.shift(q[..., -1:], group, 1)
    from_right = _comm.shift(q[..., :1], group, -1)
    left = grid.periodic_x or idx > 0
    right = grid.periodic_x or idx < nsh - 1
    parts = ([from_left] if left else []) + [q] + \
        ([from_right] if right else [])
    x0 = idx * nxl - int(left)
    cols = torch.arange(x0, x0 + nxl + int(left) + int(right),
                        device=q.device) % (nxl * nsh)
    # a global edge's dropped column still joins its shift's backward
    ext = _comm.keep(torch.cat(parts, dim=-1), group,
                     *(h for h, used in ((from_left, left),
                                         (from_right, right)) if not used))
    return ext, cols, slice(int(left), int(left) + nxl)


def sharded_squared_gradient(q: torch.Tensor, grid: Grid,
                             mesh: DeviceMesh) -> torch.Tensor:
    """|grad q|^2 of the rank's (B_local, Ny, Nx_local) block, equal to
    :func:`..ops.stencil.squared_gradient` of the whole grid on these
    columns.  Each shard must hold at least 2 columns where x is not
    periodic."""
    ext, cols, own = _halo(q, grid, mesh)
    dy, dx = _spacing(grid, q.dtype)
    Ny = q.shape[-2]
    rdx = (1.0 / dx)[:, cols].contiguous()
    rdy = (1.0 / dy).contiguous()
    ef = ext.reshape(-1, Ny, ext.shape[-1]).contiguous()
    kw = dict(periodic_x=False, bc_y=grid.bc_y)
    if needs_grad(ef, rdx, rdy):
        out = _SquaredGradient.apply(ef, rdx, rdy, kw)
    else:
        out = _k1.squared_gradient(ef, rdx, rdy, **kw)
    return out[..., own].reshape(q.shape)


def sharded_gradient(q: torch.Tensor, grid: Grid, mesh: DeviceMesh):
    """(dq/dy, dq/dx) of the rank's block, equal to
    :func:`..ops.stencil.gradient` of the whole grid on these columns."""
    ext, cols, own = _halo(q, grid, mesh)
    dy, dx = _spacing(grid, q.dtype)
    qx = _centered_x(ext, False)[..., own] / dx[:, cols[own]]
    qy = _centered_y(q, grid.bc_y) / dy[:, None]
    return qy, qx
