"""Finite-difference gradients on the analysis plane.

Counterpart of ``xcontour_tpu/ops/stencil.py``: second-order centered
differences, periodic or extended x boundaries, y walls per ``bc_y``, and
the spherical metric dx = R cos(lat) dlon.  :func:`squared_gradient` runs
the K1 kernel wrapper (:mod:`..kernels.stencil`) at every size, and
:func:`clength_weights` the contour-length chain's weights through G
(:mod:`..kernels.gradw`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import Grid
from ..kernels import needs_grad, vjp
from ..kernels import gradw as _g
from ..kernels import stencil as _k1
from ..kernels.stencil import _centered_x, _centered_y
from .gradient import gradient_index
from ..utils.constants import Rearth as _REARTH


def _spacing(grid: Grid, dtype):
    """Physical grid spacings (np.gradient of the coordinate vectors),
    computed in ``dtype`` like the JAX package: at the poles of a lat/lon
    grid cos(lat) is then tiny but not zero in float32, so |grad q|^2 stays
    finite there."""
    y = grid.ydef.to(dtype)
    x = grid.xdef.to(dtype)
    gy = gradient_index(y)
    gx = gradient_index(x)
    if grid.latlon:
        d2r = np.pi / 180.0
        dy = gy * d2r * _REARTH
        dx = torch.cos(y * d2r)[:, None] * (gx * d2r * _REARTH)[None, :]
    else:
        dy = gy
        dx = torch.broadcast_to(gx[None, :], (y.shape[0], x.shape[0]))
    return dy, dx


def gradient(q: torch.Tensor, grid: Grid, bc_y: str | None = None):
    """(dq/dy, dq/dx) in physical units on the plane (..., Ny, Nx).
    ``bc_y`` None selects the grid's."""
    if bc_y is None:
        bc_y = grid.bc_y
    dy, dx = _spacing(grid, q.dtype)
    qx = _centered_x(q, grid.periodic_x) / dx
    qy = _centered_y(q, bc_y) / dy[:, None]
    return qy, qx


class _SquaredGradient(torch.autograd.Function):
    """K1 with the plain version's VJP (JAX:
    ``ops/stencil._squared_gradient_pallas_ad``), recomputed elementwise
    under autograd."""

    @staticmethod
    def forward(ctx, q, rdx, rdy, kw):
        ctx.save_for_backward(q, rdx, rdy)
        ctx.kw = kw
        return _k1.squared_gradient(q.detach(), rdx.detach(), rdy.detach(),
                                    **kw)

    @staticmethod
    def backward(ctx, g):
        plain = lambda t: _k1.squared_gradient_plain(*t, **ctx.kw)
        return (*vjp([(plain, g)], ctx.saved_tensors,
                     ctx.needs_input_grad[:3]), None)


def squared_gradient(q: torch.Tensor, grid: Grid,
                     bc_y: str | None = None) -> torch.Tensor:
    """|grad q|^2 (the Keff integrand) of (..., Ny, Nx) snapshots, through
    the K1 wrapper (reciprocal spacings, multiplied); differentiable
    through :class:`_SquaredGradient`."""
    if bc_y is None:
        bc_y = grid.bc_y
    dy, dx = _spacing(grid, q.dtype)
    Ny, Nx = q.shape[-2:]
    rdx = (1.0 / dx).contiguous()
    rdy = (1.0 / dy).contiguous()
    qf = q.reshape(-1, Ny, Nx).contiguous()
    kw = dict(periodic_x=grid.periodic_x, bc_y=bc_y)
    if needs_grad(qf, rdx, rdy):
        out = _SquaredGradient.apply(qf, rdx, rdy, kw)
    else:
        out = _k1.squared_gradient(qf.detach(), rdx.detach(), rdy.detach(),
                                   **kw)
    return out.reshape(q.shape)


class _ClengthWeights(torch.autograd.Function):
    """G with the plain version's VJP, one output a channel: a channel
    that no differentiated output uses gets no cotangent, whose zeros
    would carry NaN back through 1/grdm and sqrt where grdm is 0 (the JAX
    package leaves such a channel out of its VJP)."""

    @staticmethod
    def forward(ctx, q, dx, dy, dA, kw):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, dx, dy, dA)
        ctx.kw = kw
        out = _g.clength_weights(q.detach(), dx.detach(), dy.detach(),
                                 dA.detach(), **kw)
        return tuple(c.clone() for c in out.unbind(1))

    @staticmethod
    def backward(ctx, *grads):
        live = [c for c, g in enumerate(grads) if g is not None]
        if not live:
            return (None,) * 5

        def plain(t):
            ws = _g.channels(*t, **ctx.kw)
            return torch.stack([torch.broadcast_to(ws[c], t[0].shape)
                                for c in live], dim=1)
        g = torch.stack([grads[c] for c in live], dim=1)
        return (*vjp([(plain, g)], ctx.saved_tensors,
                     ctx.needs_input_grad[:4]), None)


def clength_weights(q: torch.Tensor, grid: Grid, dA: torch.Tensor):
    """The contour-length chain's five CDF weights of (..., Ny, Nx)
    snapshots, [dA, grdS dA, (grdm grdm) dA, grdm dA, ((1 / grdm) grdm)
    dA] with grdS = |grad q|^2 (:func:`gradient`'s, the grid's y walls)
    and grdm its root, through G: a (..., 5, Ny, Nx) tensor; where a
    gradient is needed, the tuple of the five (..., Ny, Nx) channels of
    :class:`_ClengthWeights`."""
    dy, dx = _spacing(grid, q.dtype)
    Ny, Nx = q.shape[-2:]
    qf = q.reshape(-1, Ny, Nx).contiguous()
    dx, dy, dA = dx.contiguous(), dy.contiguous(), dA.contiguous()
    kw = dict(periodic_x=grid.periodic_x, bc_y=grid.bc_y)
    if needs_grad(qf, dx, dy, dA):
        return tuple(c.reshape(q.shape)
                     for c in _ClengthWeights.apply(qf, dx, dy, dA, kw))
    out = _g.clength_weights(qf.detach(), dx.detach(), dy.detach(),
                             dA.detach(), **kw)
    return out.reshape(q.shape[:-2] + out.shape[1:])
