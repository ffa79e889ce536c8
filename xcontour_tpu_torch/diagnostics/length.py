"""Contour geometry: perimeter lengths and box-counting crossing lengths.

Counterpart of ``xcontour_tpu/diagnostics/length.py``.  Perimeters are
traversal-free marching squares (every cell measures its own segments, a
sum per level) through the K7 wrapper (:mod:`..kernels.length`); an empty
contour gives NaN.  Box counting pads x once by the largest stride and
sums, for each level, the weights of the (stride+1)-point boxes whose
NaN-skipping min and max straddle it, every stride in one call of the B
wrapper (:mod:`..kernels.boxcount`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import boxcount as _bc
from ..kernels import length as _k7
from ..kernels import needs_grad
from ..utils.constants import Rearth as _REARTH


def contour_lengths(data: torch.Tensor, contours: torch.Tensor,
                    ydef: torch.Tensor, xdef: torch.Tensor, *,
                    latlon: bool = False, Rearth: float = _REARTH,
                    chunk: int = 8) -> torch.Tensor:
    """Perimeter of each contour level.

    data : (..., Ny, Nx); contours : (..., N) or (N,); ydef/xdef :
    coordinate vectors (degrees if latlon, meters otherwise).  Returns
    (..., N); a contour of zero total length gives NaN.  ``chunk`` bounds
    the plain version's memory (levels per step).
    """
    # radians in the coordinate's own dtype, then the data's dtype
    yc = torch.deg2rad(ydef) if latlon else ydef
    xc = torch.deg2rad(xdef) if latlon else xdef
    yc = yc.to(data.dtype).contiguous()
    xc = xc.to(data.dtype).contiguous()
    batch = data.shape[:-2]
    Ny, Nx = data.shape[-2:]
    N = contours.shape[-1]
    ctr = torch.broadcast_to(contours, batch + (N,))
    df = data.reshape(-1, Ny, Nx).contiguous()
    cf = ctr.reshape(-1, N).contiguous()
    if needs_grad(df, cf, yc, xc):
        totals = _ContourLengths.apply(df, cf, yc, xc, latlon, chunk)
    else:
        totals = _k7.contour_lengths(df.detach(), cf.detach(), yc.detach(),
                                     xc.detach(), latlon=latlon, chunk=chunk)
    totals = totals.reshape(batch + (N,))
    totals = torch.where(totals == 0, torch.full_like(totals, float("nan")),
                         totals)
    return totals * Rearth if latlon else totals


class _ContourLengths(torch.autograd.Function):
    """K7 with the plain version's VJP (JAX:
    ``diagnostics/length._lengths_pallas_ad``), recomputed a chunk of
    levels at a time (:func:`..kernels.length.contour_lengths_vjp`)."""

    @staticmethod
    def forward(ctx, data, levels, yc, xc, latlon, chunk):
        ctx.save_for_backward(data, levels, yc, xc)
        ctx.latlon, ctx.chunk = latlon, chunk
        return _k7.contour_lengths(data.detach(), levels.detach(),
                                   yc.detach(), xc.detach(), latlon=latlon,
                                   chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        grads = _k7.contour_lengths_vjp(*ctx.saved_tensors, g,
                                        ctx.needs_input_grad[:4],
                                        latlon=ctx.latlon, chunk=ctx.chunk)
        return (*grads, None, None)


_PAD_MODES = ("edge", "wrap", "reflect", "symmetric", "constant", "empty",
              "mean", "maximum", "minimum", "median", "linear_ramp")


def _pad_index(n: int, pad: int, mode: str, device) -> torch.Tensor:
    """Source columns of ``pad`` columns appended to ``n`` by np.pad's
    ``mode`` (edge, wrap, reflect, symmetric)."""
    j = torch.arange(n, n + pad, device=device)
    if mode == "edge":
        return torch.full_like(j, n - 1)
    if mode == "wrap":
        return j % n
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(j)
        j = j % (2 * n - 2)
        return torch.where(j >= n, 2 * n - 2 - j, j)
    j = j % (2 * n)                                      # symmetric
    return torch.where(j >= n, 2 * n - 1 - j, j)


def _median(a: torch.Tensor) -> torch.Tensor:
    """np.median along the last axis, kept as an axis of one: the mean of
    the two middle values for an even count, NaN where a row holds NaN
    (torch.median takes the lower middle value)."""
    n = a.shape[-1]
    s = torch.sort(a, dim=-1).values
    lo, hi = (n - 1) // 2, n // 2
    med = (s[..., lo:lo + 1] + s[..., hi:hi + 1]) / 2
    return torch.where(torch.isnan(a).any(-1, keepdim=True),
                       torch.full_like(med, float("nan")), med)


_STATS = {"mean": lambda a: a.mean(-1, keepdim=True),
          "maximum": lambda a: a.amax(-1, keepdim=True),
          "minimum": lambda a: a.amin(-1, keepdim=True),
          "median": _median}


def _pad_x(a: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """np.pad(a, [(0, 0), ..., (0, pad)], mode) along the last axis, as
    jnp.pad computes it: the statistic modes over the whole row (NaN where
    the row holds NaN), 'linear_ramp' from the edge value down to 0.
    'constant' appends zeros, and so does 'empty', whose values np.pad
    leaves undefined."""
    if callable(mode) or mode not in _PAD_MODES:
        raise ValueError(f"pad mode {mode!r} is not supported; use one of "
                         f"{_PAD_MODES} (np.pad's function form is not)")
    if pad == 0:
        return a
    shape = a.shape[:-1] + (pad,)
    if mode in ("constant", "empty"):
        tail = a.new_zeros(shape)
    elif mode in _STATS:
        tail = _STATS[mode](a).expand(shape)
    elif mode == "linear_ramp":
        # jnp.linspace(0, edge, pad, endpoint=False), reversed
        k = torch.arange(pad - 1, -1, -1, dtype=a.dtype, device=a.device)
        tail = a[..., -1:] * (k / pad)
    else:
        tail = a[..., _pad_index(a.shape[-1], pad, mode, a.device)]
    return torch.cat([a, tail], dim=-1)


def box_counting_lengths(data, contours, area, strides: Sequence[int], *,
                         mode: str = "edge", quirks: bool = False
                         ) -> torch.Tensor:
    """Box-counting crossing lengths (..., N, S), one column a stride of
    ``strides``: x padded once by the largest stride, then every stride in
    one call of :func:`..kernels.boxcount.box_counts` (a launch on the
    card).  Only ``area`` carries a gradient."""
    strides = tuple(int(s) for s in strides)
    pad_x = max(strides)
    d = _pad_x(data, pad_x, mode)
    a = _pad_x(area, pad_x, mode)
    if needs_grad(a):
        return _BoxCounts.apply(d, contours, a, strides, quirks)
    return _bc.box_counts(d.detach(), contours.detach(), a.detach(), strides,
                          quirks=quirks)


class _BoxCounts(torch.autograd.Function):
    """Box counting with the plain version's VJP in the areas, recomputed a
    stride at a time (:func:`..kernels.boxcount.box_counts_vjp`)."""

    @staticmethod
    def forward(ctx, data, contours, area, strides, quirks):
        ctx.save_for_backward(data, contours, area)
        ctx.strides, ctx.quirks = strides, quirks
        return _bc.box_counts(data.detach(), contours.detach(), area.detach(),
                              strides, quirks=quirks)

    @staticmethod
    def backward(ctx, g):
        ga = _bc.box_counts_vjp(*ctx.saved_tensors, g, ctx.strides,
                                ctx.quirks)
        return None, None, ga, None, None


def contour_crossing(data, contours, area, stride=1, *, mode: str = "edge",
                     quirks: bool = False):
    """Box-counting crossing length(s): every (stride+1)-point box whose
    values straddle a level adds sqrt(area) * stride.

    ``stride`` is an int or a sequence of ints (then a list is returned).
    x is padded once by the largest stride with np.pad's ``mode``: 'edge',
    'wrap', 'reflect', 'symmetric', 'constant', 'mean', 'maximum',
    'minimum', 'median', 'linear_ramp' or 'empty' (filled as 'constant').
    ``quirks=True`` keeps the reference's indexing bugs (column boxes
    bounded by the row count, area indexed by box); the default is the
    corrected full-width form.
    """
    if isinstance(stride, Sequence):
        out = box_counting_lengths(data, contours, area, stride, mode=mode,
                                   quirks=quirks)
        return [out[..., j] for j in range(len(stride))]
    return box_counting_lengths(data, contours, area, [stride], mode=mode,
                                quirks=quirks)[..., 0]
