"""The sharded pipeline steps: ``..pipeline``'s own steps on a mesh layout.

The JAX package has no module here: GSPMD derives the sharded programs
from ``pipeline.*`` on sharded inputs.  The port runs the same bodies:
each step here is its twin in ``..pipeline`` given a mesh's layout
(``_layout=``), which answers the operations that reach the grid's x axis
on the rank's block.  Each step takes the rank's (B_local, Ny, Nx_local)
block of the snapshots and the whole grid (its metrics replicated on
every rank, as JAX replicates the grid's leaves), has the arguments and
returns the keys of its unsharded twin, emits the same ``stage.*`` spans,
and runs:

1. |grad q|^2 with a halo (:func:`.stencil.sharded_squared_gradient`);
2. the contour levels from a min/max all-reduce over 'x' of the local
   extrema, NaN cells masked to +-inf before the reduce and the
   infinities mapped to NaN after it (an all-NaN slab does not poison the
   reduction);
3. the A(Y_eq) table, built from the whole grid unless one is passed
   in: one K2 launch on every rank, whose float atomics differ between
   launches, so x rank 0's values are broadcast over 'x'
   (:func:`replicated_table`) and every output replicated over 'x' is the
   same on every x rank;
4. the conditional integrals, one K2 launch and one sum over 'x'
   (:func:`.histogram.sharded_weighted_cdf_multi`), or the broadcast
   integrals of the slab and their sums over 'x';
5. the lookup, Lmin and the Keff tail, replicated;
6. the sorted profile Q, replicated;
7. LWA on each slab (:func:`.lwa.sharded_local_wave_activity`), no
   collective;
8. K7's perimeters on each slab plus its halo column
   (:func:`.length.sharded_contour_lengths`).

Outputs in :data:`X_SHARDED` are the rank's x block of a plane field;
every other output is replicated over 'x'.  Masks passed in are whole
(Ny, Nx).

Gradients go through every step as ``jax.grad`` goes through the
unsharded one: the halo stencil (K1's Function, the halo's cotangent
shifted back), the levels (the min/max's cotangent split over the tied
cells of every rank), the conditional integrals (K2's Function, the
cotangents summed over 'x'), the replicated tail, and LWA on each slab
(the LWA kernels' Function).  A supplied ``grdS`` that requires grad is
differentiated too.  Each rank differentiates a loss on its own outputs,
counting a replicated output once per mesh (:func:`.mesh.once_per_mesh`);
its ``.backward()`` then yields its block of the tracer's gradient.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import core
from ..grid import Grid
from ..kernels import needs_grad
from ..pipeline import (clength_pipeline, keff_lwa_pipeline, keff_pipeline,
                        lwa_pipeline)
from . import _comm
from .histogram import sharded_weighted_cdf_multi
from .length import sharded_contour_lengths
from .lwa import sharded_local_wave_activity, sharded_local_wave_activity2
from .mesh import X, x_block
from .stencil import sharded_gradient, sharded_squared_gradient

# the outputs that are the rank's x block of a plane field
X_SHARDED = frozenset({"lwa", "lwa2", "lwa_upper", "lwa_lower", "lwa2_upper",
                       "lwa2_lower"})


def sharded_contours(tracer: torch.Tensor, N: int, mesh: DeviceMesh, *,
                     increase: bool = True):
    """:func:`..core.cal_contours` of the whole snapshots from the rank's
    block: the local extrema reduced over 'x'.  An extremum's cotangent is
    split equally over the cells that attain it, on every rank (JAX's
    min/max split between ties)."""
    group = mesh.get_group(X)
    mmin, mmax = core.masked_extrema(tracer)
    ties = [None, None]
    if _comm.size(group) > 1 and needs_grad(tracer):
        # the cells each local extremum stands for
        ties = [(tracer == m[..., None, None]).sum(dim=(-2, -1))
                for m in (mmin, mmax)]
    return core.levels_from_extrema(_comm.min_(mmin, group, ties[0]),
                                    _comm.max_(mmax, group, ties[1]), N,
                                    increase=increase)


def replicated_table(table: core.Table, mesh: DeviceMesh) -> core.Table:
    """``table`` with x rank 0's values on every x rank.  A table built by
    K2 on each rank differs between ranks in the order of its float sums;
    a table passed to a sharded step must be the same on every x rank,
    which this makes it."""
    return core.Table(values=_comm.broadcast(table.values,
                                             mesh.get_group(X)),
                      coords=table.coords)


class _MeshLayout:
    """The layout of a snapshot whose x axis is split over ``mesh``'s 'x':
    ``..pipeline._PLANE``'s names on the rank's block.  The stencil takes
    a halo, the levels and the integrals are reduced over 'x', the
    histogram table is x rank 0's, and LWA and the lengths run on the
    slab."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.squared_gradient = partial(sharded_squared_gradient, mesh=mesh)
        self.gradient = partial(sharded_gradient, mesh=mesh)
        self.contours = partial(sharded_contours, mesh=mesh)
        self.cdf = partial(sharded_weighted_cdf_multi, mesh=mesh)
        self.lwa = partial(sharded_local_wave_activity, mesh=mesh)
        self.lwa2 = partial(sharded_local_wave_activity2, mesh=mesh)
        self.lengths = partial(sharded_contour_lengths, mesh=mesh)

    def block(self, dA, nx: int):
        return x_block(self.mesh, dA, nx)

    def hist_table(self, mask, ydef, dA, *, increase, lt):
        return replicated_table(core.cal_area_eqCoord_table_hist(
            mask, ydef, dA, increase=increase, lt=lt), self.mesh)

    def integral(self, tracer, ctr, dA, integrand, *, lt):
        part = core.cal_integral_within_contours(tracer, ctr, dA, integrand,
                                                 lt=lt)
        return _comm.sum_(part, self.mesh.get_group(X))


def sharded_keff_pipeline(tracer: torch.Tensor, grid: Grid, mesh: DeviceMesh,
                          grdS: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          pre_y: Optional[torch.Tensor] = None, *,
                          N: int = 251, increase: bool = True,
                          lt: bool = True, hist: bool = True,
                          lmin: str = "dxF", nkeff_mask: float = 2e7,
                          table: Optional[core.Table] = None) -> dict:
    """:func:`..pipeline.keff_pipeline` on the rank's block; ``grdS`` is
    the block's, ``mask`` whole.  hist=False sums the broadcast integrals
    of each slab over 'x' (the table from the whole grid)."""
    return keff_pipeline(tracer, grid, grdS, mask, pre_y, N=N,
                         increase=increase, lt=lt, hist=hist, lmin=lmin,
                         nkeff_mask=nkeff_mask, table=table,
                         _layout=_MeshLayout(mesh))


def sharded_lwa_pipeline(tracer: torch.Tensor, grid: Grid, mesh: DeviceMesh,
                         mask: Optional[torch.Tensor] = None, *, N: int = 121,
                         increase: bool = True, lt: bool = True,
                         part: str = "all", metric: str = "dA",
                         lwa_method: str = "auto",
                         table: Optional[core.Table] = None) -> dict:
    """:func:`..pipeline.lwa_pipeline` on the rank's block: LWA (K3) and
    LWA2 (K5) on each slab for 'auto' (K4 for a part, 'split' among them:
    both halves a launch)."""
    return lwa_pipeline(tracer, grid, mask, N=N, increase=increase, lt=lt,
                        part=part, metric=metric, lwa_method=lwa_method,
                        table=table, _layout=_MeshLayout(mesh))


def sharded_keff_lwa_pipeline(tracer: torch.Tensor, grid: Grid,
                              mesh: DeviceMesh,
                              grdS: Optional[torch.Tensor] = None,
                              mask: Optional[torch.Tensor] = None,
                              pre_y: Optional[torch.Tensor] = None, *,
                              N: int = 121, increase: bool = True,
                              lt: bool = True, lmin: str = "analytic",
                              metric: str = "dA", with_lwa2: bool = False,
                              lwa_method: str = "auto",
                              table: Optional[core.Table] = None) -> dict:
    """:func:`..pipeline.keff_lwa_pipeline` on the rank's block, the main
    path: K1 on the halo-extended slab, K2 once for the table (unless
    given) and once for the two integrals, K3 (or K4) on the slab."""
    return keff_lwa_pipeline(tracer, grid, grdS, mask, pre_y, N=N,
                             increase=increase, lt=lt, lmin=lmin,
                             metric=metric, with_lwa2=with_lwa2,
                             lwa_method=lwa_method, table=table,
                             _layout=_MeshLayout(mesh))


def sharded_clength_pipeline(tracer: torch.Tensor, grid: Grid,
                             mesh: DeviceMesh,
                             mask: Optional[torch.Tensor] = None, *,
                             N: int = 121, increase: bool = True,
                             lt: bool = True,
                             table: Optional[core.Table] = None) -> dict:
    """:func:`..pipeline.clength_pipeline` on the rank's block: the five
    integrals in one K2 launch and one sum over 'x', the perimeters by
    :func:`.length.sharded_contour_lengths` (K7 on each slab plus its
    halo column)."""
    return clength_pipeline(tracer, grid, mask, N=N, increase=increase,
                            lt=lt, table=table, _layout=_MeshLayout(mesh))
