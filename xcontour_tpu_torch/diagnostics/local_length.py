"""Windowed (local) contour lengths.

Counterpart of ``xcontour_tpu/diagnostics/local_length.py``: for each
(window x window) tile of a 2-D field, or of each field of a batch,
anchored every ``stride`` points, the length of the contour at the tile's
mean tracer value.  The window means come from the R wrapper
(:mod:`..kernels.rolling`: one launch a call on the card, integral images
on the CPU); the lengths from the K8 wrapper (:mod:`..kernels.length`),
one launch a call.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import length as _k8
from ..kernels import needs_grad, vjp
from ..kernels import rolling as _rolling
from ..utils.constants import Rearth as _REARTH
from ..utils.prof import span


class _WindowMeans(torch.autograd.Function):
    """R on a field or a batch with the plain version's VJP, the integral
    images recomputed under autograd (the JAX package differentiates its
    plain jnp)."""

    @staticmethod
    def forward(ctx, data, window, stride, min_count):
        ctx.save_for_backward(data)
        ctx.kw = (window, stride, min_count)
        return _rolling.window_means(data.detach(), window, stride, min_count)

    @staticmethod
    def backward(ctx, g):
        data, = ctx.saved_tensors
        piece = (lambda p: _rolling.window_means_plain(p[0], *ctx.kw), g)
        return (*vjp([piece], (data,), (True,)), None, None, None)


def rolling_mean(data: torch.Tensor, window: int, stride: int,
                 min_count: int = 1):
    """NaN-skipping mean over (window x window) tiles anchored at strided
    top-left corners; a tile with fewer than ``min_count`` valid points
    gives NaN (where ``min_count`` <= 0, one with none gives the field's
    finite mean).  Returns (means (..., Wy, Wx), oy, ox)."""
    if data.device.type == "cuda":
        data = data.contiguous()
    if needs_grad(data):
        means = _WindowMeans.apply(data, window, stride, min_count)
    else:
        means = _rolling.window_means(data, window, stride, min_count)
    ny, nx = data.shape[-2:]
    # no window when it is larger than the field (numpy's empty range)
    oy = torch.arange(0, max(0, ny - window + 1), stride, device=data.device)
    ox = torch.arange(0, max(0, nx - window + 1), stride, device=data.device)
    return means, oy, ox


class _LocalLengths(torch.autograd.Function):
    """K8 on a field (Ny, Nx) or a batch (B, Ny, Nx) with the plain
    version's VJP (JAX: ``diagnostics/local_length._local_pallas_ad``),
    recomputed a field and a chunk of window rows at a time
    (:func:`..kernels.length.local_lengths_vjp`)."""

    @staticmethod
    def forward(ctx, data, levels, yc, xc, kw):
        ctx.save_for_backward(data, levels, yc, xc)
        ctx.kw = kw
        return _k8.local_lengths(data.detach(), levels.detach(), yc.detach(),
                                 xc.detach(), **kw)

    @staticmethod
    def backward(ctx, g):
        grads = _k8.local_lengths_vjp(*ctx.saved_tensors, g,
                                      ctx.needs_input_grad[:4], **ctx.kw)
        return (*grads, None)


def _window_centers(ydef, xdef, oy, ox, window: int):
    """Window-center coordinates (the anchors when the grid is narrower
    than half a window)."""
    cy = ydef[oy + window // 2] if window // 2 < ydef.shape[0] else ydef[oy]
    cx = xdef[ox + window // 2] if window // 2 < xdef.shape[0] else xdef[ox]
    return cy, cx


def local_lengths_and_means(data: torch.Tensor, ydef: torch.Tensor,
                            xdef: torch.Tensor, *, window: int, stride: int,
                            latlon: bool = True, min_count: int = 1,
                            levels: Optional[torch.Tensor] = None,
                            Rearth: float = _REARTH):
    """The body of :func:`local_contour_lengths` and
    :func:`..pipeline.local_length_pipeline`: one rolling mean (span
    ``stage.rolling``) and one K8 launch for the whole batch, with the NaN
    and empty mask and the Earth-radius scale (span
    ``stage.local_lengths``).  Returns (lengths, window means, window-center
    y, x)."""
    with span("stage.rolling"):
        means, oy, ox = rolling_mean(data, window, stride, min_count)
    if levels is None:
        levels = means
    with span("stage.local_lengths"):
        yc = torch.deg2rad(ydef) if latlon else ydef
        xc = torch.deg2rad(xdef) if latlon else xdef
        yc = yc.to(data.dtype).contiguous()
        xc = xc.to(data.dtype).contiguous()
        # one field stays 2-D; leading dimensions fold into one batch
        fold = (lambda a: a.reshape((-1,) + a.shape[-2:])) \
            if data.dim() > 3 else (lambda a: a)
        d, lv = fold(data).contiguous(), fold(levels).contiguous()
        kw = dict(window=window, stride=stride, latlon=latlon)
        if needs_grad(d, lv, yc, xc):
            totals = _LocalLengths.apply(d, lv, yc, xc, kw)
        else:
            totals = _k8.local_lengths(d.detach(), lv.detach(), yc.detach(),
                                       xc.detach(), **kw)
        totals = totals.reshape(levels.shape)
        lengths = torch.where(torch.isnan(levels) | (totals == 0),
                              torch.full_like(totals, float("nan")), totals)
        if latlon:
            lengths = lengths * Rearth
    cy, cx = _window_centers(ydef, xdef, oy, ox, window)
    return lengths, means, cy, cx


def local_contour_lengths(data: torch.Tensor, ydef: torch.Tensor,
                          xdef: torch.Tensor, *, window: int = 101,
                          stride: int = 10, latlon: bool = True,
                          min_count: int = 1,
                          levels: Optional[torch.Tensor] = None,
                          Rearth: float = _REARTH):
    """Per-window contour length at the window-mean level.

    data : (..., Ny, Nx).  Returns (lengths (..., Wy, Wx), window-center
    y, x): one rolling mean and one K8 launch for the whole batch.
    ``levels`` overrides the rolling-mean levels (the same shape).  An
    empty window or contour gives NaN.
    """
    lengths, _, cy, cx = local_lengths_and_means(
        data, ydef, xdef, window=window, stride=stride, latlon=latlon,
        min_count=min_count, levels=levels, Rearth=Rearth)
    return lengths, cy, cx
