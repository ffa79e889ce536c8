"""The sharded pipeline steps, composed from the sharded functions.

The JAX package has no module here: GSPMD derives the sharded programs
from ``pipeline.*`` on sharded inputs.  The port writes them out.  Each
step takes the rank's (B_local, Ny, Nx_local) block of the snapshots and
the whole grid (its metrics replicated on every rank, as JAX replicates
the grid's leaves), has the arguments and returns the keys of its
unsharded twin in ``..pipeline``, and runs:

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
   (:func:`.histogram.sharded_weighted_cdf_multi`);
5. the lookup, Lmin and the Keff tail, replicated;
6. the sorted profile Q, replicated;
7. LWA on each slab (:func:`.lwa.sharded_local_wave_activity`), no
   collective.

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

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import core
from .. import pipeline as _p
from ..grid import Grid
from ..kernels import needs_grad
from . import _comm
from .histogram import sharded_weighted_cdf_multi
from .length import sharded_contour_lengths
from .lwa import sharded_local_wave_activity, sharded_local_wave_activity2
from .mesh import X, x_block
from .stencil import sharded_gradient, sharded_squared_gradient

# the outputs that are the rank's x block of a plane field
X_SHARDED = frozenset({"lwa", "lwa2"})


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


def _hist_table(mask, ydef, dA, mesh, increase, lt):
    return replicated_table(core.cal_area_eqCoord_table_hist(
        mask, ydef, dA, increase=increase, lt=lt), mesh)


def _sharded_broadcast_integral(tracer, ctr, dA, integrand, lt, mesh):
    part = core.cal_integral_within_contours(tracer, ctr, dA, integrand,
                                             lt=lt)
    return _comm.sum_(part, mesh.get_group(X))


def _setup(tracer, grid, mesh, mask):
    dtype = tracer.dtype
    ydef = grid.ydef.to(dtype)
    dA = grid.dA.to(dtype)
    if mask is None:
        mask = grid.fluid_mask(dtype)
    return ydef, dA, x_block(mesh, dA, tracer.shape[-1]), mask


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
    _p._check_modes(lmin=lmin)
    ydef, dA, dA_l, mask = _setup(tracer, grid, mesh, mask)
    if grdS is None:
        grdS = sharded_squared_gradient(tracer, grid, mesh)
    ctr = sharded_contours(tracer, N, mesh, increase=increase)
    if hist:
        if table is None:
            table = _hist_table(mask, ydef, dA, mesh, increase, lt)
        intArea, intgrdS = sharded_weighted_cdf_multi(
            tracer, ctr, [dA_l, grdS * dA_l], lt, mesh)
    else:
        if table is None:
            table = core.cal_area_eqCoord_table(mask, ydef, dA,
                                                increase=increase, lt=lt)
        intArea = _sharded_broadcast_integral(tracer, ctr, dA_l, None, lt,
                                              mesh)
        intgrdS = _sharded_broadcast_integral(tracer, ctr, dA_l, grdS, lt,
                                              mesh)
    Yeq = table.lookup_coordinates(intArea)
    Lmin = _p._lmin(lmin, Yeq, grid, mask, ydef)
    k = _p._keff(ctr, intArea, intgrdS, Lmin, nkeff_mask)
    origin = dict(contour=ctr, intArea=intArea, Yeq=Yeq, intgrdS=intgrdS,
                  dgrdSdA=k["dgrdSdA"], dqdA=k["dqdA"], Leq2=k["Leq2"],
                  Lmin=Lmin, nkeff=k["nkeff"], table=table.values)
    out = dict(origin=origin)
    if pre_y is not None:
        pre_y = pre_y.to(tracer.dtype)
        out["interp"] = {key: core.interp_to_coords(pre_y, Yeq, v)
                         for key, v in origin.items() if key != "table"}
    return out


def sharded_lwa_pipeline(tracer: torch.Tensor, grid: Grid, mesh: DeviceMesh,
                         mask: Optional[torch.Tensor] = None, *, N: int = 121,
                         increase: bool = True, lt: bool = True,
                         part: str = "all", metric: str = "dA",
                         lwa_method: str = "auto",
                         table: Optional[core.Table] = None) -> dict:
    """:func:`..pipeline.lwa_pipeline` on the rank's block: LWA (K3) and
    LWA2 (K5) on each slab for 'auto'."""
    _p._check_modes(metric=metric)
    ydef, dA, dA_l, mask = _setup(tracer, grid, mesh, mask)
    weight = _p._lwa_weight(metric, grid, dA)
    if table is None:
        table = _hist_table(mask, ydef, dA, mesh, increase, lt)
    ctr = sharded_contours(tracer, N, mesh, increase=increase)
    intArea, = sharded_weighted_cdf_multi(tracer, ctr, [dA_l], lt, mesh)
    latEq = table.lookup_coordinates(intArea)
    Q = core.interp_to_coords(ydef, latEq, ctr)
    kw = dict(increase=increase, part=part, weight=weight, method=lwa_method)
    lwa = sharded_local_wave_activity(tracer, Q, dA, ydef, mesh, **kw)
    lwa2 = sharded_local_wave_activity2(tracer, Q, dA, ydef, mesh, **kw)
    return dict(contour=ctr, intArea=intArea, latEq=latEq, Q=Q, lwa=lwa,
                lwa2=lwa2)


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
    _p._check_modes(lmin=lmin, metric=metric)
    ydef, dA, dA_l, mask = _setup(tracer, grid, mesh, mask)
    if grdS is None:
        grdS = sharded_squared_gradient(tracer, grid, mesh)
    if table is None:
        table = _hist_table(mask, ydef, dA, mesh, increase, lt)
    ctr = sharded_contours(tracer, N, mesh, increase=increase)
    intArea, intgrdS = sharded_weighted_cdf_multi(
        tracer, ctr, [dA_l, grdS * dA_l], lt, mesh)
    Yeq = table.lookup_coordinates(intArea)
    Lmin = _p._lmin(lmin, Yeq, grid, mask, ydef)
    k = _p._keff(ctr, intArea, intgrdS, Lmin, 2e7)

    Q = core.interp_to_coords(ydef, Yeq, ctr)
    kw = dict(increase=increase, part="all",
              weight=_p._lwa_weight(metric, grid, dA), method=lwa_method)
    lwa = sharded_local_wave_activity(tracer, Q, dA, ydef, mesh, **kw)
    out = dict(contour=ctr, intArea=intArea, intgrdS=intgrdS, Yeq=Yeq,
               Lmin=Lmin, Leq2=k["Leq2"], nkeff=k["nkeff"], Q=Q, lwa=lwa)
    if with_lwa2:
        out["lwa2"] = sharded_local_wave_activity2(tracer, Q, dA, ydef, mesh,
                                                   **kw)
    if pre_y is not None:
        pre_y = pre_y.to(tracer.dtype)
        for key in ("Leq2", "nkeff", "Lmin"):
            out[key + "_at"] = core.interp_to_coords(pre_y, Yeq, out[key])
    return out


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
    ydef, dA, dA_l, mask = _setup(tracer, grid, mesh, mask)
    qy, qx = sharded_gradient(tracer, grid, mesh)
    grdS = qx * qx + qy * qy
    grdm = torch.sqrt(grdS)
    if table is None:
        table = _hist_table(mask, ydef, dA, mesh, increase, lt)
    ctr = sharded_contours(tracer, N, mesh, increase=increase)
    intArea, intgrdS, int_gg, int_g, int_ig = sharded_weighted_cdf_multi(
        tracer, ctr, [dA_l, grdS * dA_l, (grdm * grdm) * dA_l, grdm * dA_l,
                      ((1.0 / grdm) * grdm) * dA_l], lt, mesh)
    Yeq = table.lookup_coordinates(intArea)
    lengths = sharded_contour_lengths(tracer, ctr, grid.ydef, grid.xdef, mesh,
                                      latlon=grid.latlon)
    Lmin = _p._lmin("frac", Yeq, grid, mask, ydef)
    lower = core.cal_gradient_wrt_area(int_g, intArea)
    cmGrd = core.grad_safe_div(core.cal_gradient_wrt_area(int_gg, intArea),
                               lower)
    cmInvGrd = core.grad_safe_div(core.cal_gradient_wrt_area(int_ig, intArea),
                                  lower)
    k = _p._keff(ctr, intArea, intgrdS, Lmin, 1e5)
    return dict(contour=ctr, intArea=intArea, Yeq=Yeq, lengths=lengths,
                Lmin=Lmin, Leq2=k["Leq2"], nkeff=k["nkeff"], cmGrd=cmGrd,
                cmInvGrd=cmInvGrd)
