"""Batched monotone 1-D interpolation with np.interp semantics.

Counterpart of ``xcontour_tpu/ops/interp.py`` (its dense-compare form):

* the interval index is searchsorted(xf, x, side='right') clipped to
  [1, N-1], computed as a count of ``xf <= x`` so a NaN table entry only
  affects the queries that select it;
* a zero-width interval gives its right endpoint;
* queries outside the table clamp to the end values;
* decreasing abscissae are reversed first;
* a NaN query gives NaN.
"""

from __future__ import annotations

from typing import Union

import torch


def interp1d(x: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
             increasing: Union[bool, torch.Tensor]) -> torch.Tensor:
    """Batched np.interp.

    ``x``: (..., M) or (M,) query points; ``xf``/``yf``: (..., N) data.
    ``increasing``: direction of ``xf`` for every batch row, a bool or a
    0-d bool tensor.  Batch dims of all arguments broadcast together.
    """
    xb = x.shape[:-1] if x.dim() > 1 else ()
    batch = torch.broadcast_shapes(xb, xf.shape[:-1], yf.shape[:-1])
    M = x.shape[-1]
    N = xf.shape[-1]
    x2 = torch.broadcast_to(x, batch + (M,)).reshape(-1, M)
    xf2 = torch.broadcast_to(xf, batch + (N,)).reshape(-1, N)
    yf2 = torch.broadcast_to(yf, batch + (N,)).reshape(-1, N)
    inc = torch.as_tensor(increasing, device=xf.device)
    xfd = torch.where(inc, xf2, xf2.flip(-1))
    yfd = torch.where(inc, yf2, yf2.flip(-1))

    cnt = (x2[:, :, None] >= xfd[:, None, :]).sum(-1)
    i = torch.clamp(cnt, 1, N - 1)
    xr = torch.gather(xfd, 1, i)
    xl = torch.gather(xfd, 1, i - 1)
    yr = torch.gather(yfd, 1, i)
    yl = torch.gather(yfd, 1, i - 1)
    dx = xr - xl
    zero = dx == 0
    t = (x2 - xl) / torch.where(zero, torch.ones_like(dx), dx)
    out = torch.where(zero, yr, yl + t * (yr - yl))
    out = torch.where(x2 < xfd[:, :1], yfd[:, :1], out)
    out = torch.where(x2 > xfd[:, -1:], yfd[:, -1:], out)
    out = torch.where(torch.isnan(x2), torch.full_like(out, float("nan")), out)
    return out.reshape(batch + (M,))
