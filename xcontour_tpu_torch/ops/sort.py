"""Exact sort-based conditional integrals.

Counterpart of ``xcontour_tpu/ops/sort.py``.  The conditional integral
F(c) = sum of w over q < c (``lt``) or q > c, exactly, at sort cost:

    sort q -> prefix-sum the weights -> searchsorted the contour levels.

One batched ``torch.sort`` along the flattened grid serves every batch
element at once (the JAX package maps a single-element form over the
batch).  Semantics: strict comparisons, as the broadcast path; NaN values
and NaN weights count for nothing, NaN values sorting to the top as +inf;
no in-range window (the histogram path's [min - step, max]).  A NaN level
searches to the end of its row, so it gives the element's total for
``lt`` and 0 for ``gt`` (where the broadcast path gives 0 for both).
"""

from __future__ import annotations

import torch


def prefix_sums(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sums along ``dim`` with a leading 0: entry k is the
    sum of the first k elements."""
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [1, 0]
    return torch.nn.functional.pad(x, pad).cumsum(dim)


def exact_conditional_integral(values: torch.Tensor, bins: torch.Tensor,
                               weights: torch.Tensor, lt: bool
                               ) -> torch.Tensor:
    """Batched exact F(c) = sum of w over q < c (``lt``) or q > c.

    values : (..., Ny, Nx); bins : (N,) or (..., N), in either direction;
    weights broadcastable to values.  Returns (..., N): the broadcast
    path's sums in another order.
    """
    batch = values.shape[:-2]
    G = values.shape[-2] * values.shape[-1]
    N = bins.shape[-1]
    v = values.reshape(-1, G)
    w = torch.broadcast_to(weights, values.shape).reshape(-1, G)
    b = torch.broadcast_to(bins, batch + (N,)).reshape(-1, N)
    nan = torch.isnan(v)
    w = torch.where(nan | torch.isnan(w), torch.zeros_like(w), w)
    key = torch.where(nan, torch.full_like(v, float("inf")), v).detach()
    vs, order = torch.sort(key, dim=-1)
    csum = prefix_sums(torch.gather(w, -1, order))           # (R, G + 1)
    bd = b.detach().to(vs.dtype).contiguous()
    below = torch.gather(csum, -1, torch.searchsorted(vs, bd, side="left"))
    if lt:
        out = below
    else:
        le = torch.gather(csum, -1, torch.searchsorted(vs, bd, side="right"))
        out = csum[:, -1:] - le
    return out.reshape(batch + (N,))
