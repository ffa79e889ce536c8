"""Batched monotone 1-D interpolation with np.interp semantics.

Counterpart of ``xcontour_tpu/ops/interp.py``:

* the interval index is searchsorted(xf, x, side='right') clipped to
  [1, N-1]; small tables count ``xf <= x`` by a dense compare (a NaN table
  entry then only affects the queries that select it), large ones, or a
  compare tensor past ``_DENSE_ELEMS_MAX`` elements, search each row with
  ``torch.searchsorted`` in O(M log N) memory;
* a zero-width interval gives its right endpoint;
* queries outside the table clamp to the end values, or give NaN with
  ``extrapolate='nan'``;
* decreasing abscissae are reversed first, per batch row;
* a NaN query gives NaN.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

# the dense compare's limits, the JAX package's: past either, each row is
# searched instead of compared against the whole table
_DENSE_N_MAX = 4096
_DENSE_ELEMS_MAX = 1 << 24


def interp1d(x: torch.Tensor, xf: torch.Tensor, yf: torch.Tensor,
             increasing: Optional[Union[bool, torch.Tensor]] = None,
             extrapolate: str = "clamp") -> torch.Tensor:
    """Batched np.interp.

    ``x``: (..., M) or (M,) query points; ``xf``/``yf``: (..., N) data.
    ``increasing``: direction of ``xf``; None derives it per batch row, a
    bool or a 0-d bool tensor applies one direction to every row.
    ``extrapolate``: 'clamp' (np.interp's end values) or 'nan'.  Batch dims
    of all arguments broadcast together.
    """
    if extrapolate not in ("clamp", "nan"):
        raise ValueError(f"extrapolate={extrapolate!r} not in "
                         "['clamp', 'nan']")
    xb = x.shape[:-1] if x.dim() > 1 else ()
    batch = torch.broadcast_shapes(xb, xf.shape[:-1], yf.shape[:-1])
    M = x.shape[-1]
    N = xf.shape[-1]
    x2 = torch.broadcast_to(x, batch + (M,)).reshape(-1, M)
    xf2 = torch.broadcast_to(xf, batch + (N,)).reshape(-1, N)
    yf2 = torch.broadcast_to(yf, batch + (N,)).reshape(-1, N)
    R = x2.shape[0]
    if isinstance(increasing, bool):
        # a host value picks the order on the host: a bool copied to the
        # card would wait for the stream
        xfd, yfd = (xf2, yf2) if increasing else (xf2.flip(-1), yf2.flip(-1))
    else:
        if increasing is None:
            inc = xf2[:, -1] > xf2[:, 0]
        else:
            inc = torch.as_tensor(increasing, device=xf.device).expand(R)
        xfd = torch.where(inc[:, None], xf2, xf2.flip(-1))
        yfd = torch.where(inc[:, None], yf2, yf2.flip(-1))

    if N <= _DENSE_N_MAX and R * M * N <= _DENSE_ELEMS_MAX:
        cnt = (x2[:, :, None] >= xfd[:, None, :]).sum(-1)
    else:
        dt = torch.promote_types(x2.dtype, xfd.dtype)
        cnt = torch.searchsorted(xfd.to(dt).contiguous(),
                                 x2.to(dt).contiguous(), side="right")
    i = torch.clamp(cnt, 1, N - 1)
    xr = torch.gather(xfd, 1, i)
    xl = torch.gather(xfd, 1, i - 1)
    yr = torch.gather(yfd, 1, i)
    yl = torch.gather(yfd, 1, i - 1)
    dx = xr - xl
    zero = dx == 0
    t = (x2 - xl) / torch.where(zero, torch.ones_like(dx), dx)
    out = torch.where(zero, yr, yl + t * (yr - yl))
    outside = (x2 < xfd[:, :1], x2 > xfd[:, -1:])
    if extrapolate == "nan":
        out = torch.where(outside[0] | outside[1],
                          torch.full_like(out, float("nan")), out)
    else:
        out = torch.where(outside[0], yfd[:, :1], out)
        out = torch.where(outside[1], yfd[:, -1:], out)
    out = torch.where(torch.isnan(x2), torch.full_like(out, float("nan")), out)
    return out.reshape(batch + (M,))
