"""Fractal dimension from multi-scale contour lengths (counterpart of
``xcontour_tpu/diagnostics/fractal.py``): the closed-form least-squares
slope of log(L / ruler) against -log(ruler) along the scale axis,
skipping non-finite pairs."""

from __future__ import annotations

import torch


def loglog_slope(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Least-squares slope of y against x along the last axis, ignoring
    non-finite pairs; NaN with fewer than 2 valid points."""
    valid = torch.isfinite(x) & torch.isfinite(y)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xv = torch.where(valid, x, zero)
    yv = torch.where(valid, y, zero)
    n = valid.sum(dim=-1)
    sx = xv.sum(dim=-1)
    sy = yv.sum(dim=-1)
    sxx = (xv * xv).sum(dim=-1)
    sxy = (xv * yv).sum(dim=-1)
    denom = n * sxx - sx * sx
    slope = (n * sxy - sx * sy) / torch.where(denom == 0, zero + 1, denom)
    return torch.where((n >= 2) & (denom != 0), slope,
                       torch.full_like(slope, float("nan")))


def fractal_dimension(lengths: torch.Tensor, rulers) -> torch.Tensor:
    """Box-counting dimension per contour: lengths (..., S) at S ruler
    scales, rulers broadcastable to lengths (stride * cos(lat) *
    resolution * R).  D = slope of log(L / ruler) vs -log(ruler)."""
    rulers = torch.broadcast_to(torch.as_tensor(rulers, dtype=lengths.dtype,
                                                device=lengths.device),
                                lengths.shape)
    return loglog_slope(-torch.log(rulers), torch.log(lengths / rulers))
