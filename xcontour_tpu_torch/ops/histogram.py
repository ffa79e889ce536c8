"""Weighted-histogram CDF engine, the rearrangement primitive.

Counterpart of ``xcontour_tpu/ops/histogram.py``.  The reference's edge
semantics are kept exactly:

* one bin of width ``step`` is prepended so the output length equals the
  number of contours;
* decreasing bins are histogrammed in ascending order and the output is
  mapped back so ``out[k]`` pairs with ``bins[k]``;
* values outside [b_min - step, b_max] are excluded, the top edge is
  right-inclusive (np.histogram semantics);
* ``lt=False`` flips the CDF via total - CDF;
* NaN weights count as zero, NaN values fall in no bin.

Every CDF goes through the K2 wrapper (:mod:`..kernels.hist`), whose plain
version is the digitize + segment-sum + cumsum form (the JAX package's
``_edges_cdf_xla``).  Bins may differ per batch element.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..kernels import hist as _k2


def _edges(bf: torch.Tensor):
    """(B, N) bins -> (bincrease (B, 1), ascending edges (B, N+1)) with the
    prepended bin."""
    N = bf.shape[-1]
    bincrease = bf[:, :1] < bf[:, -1:]
    asc = torch.where(bincrease, bf, bf.flip(-1))
    step = (asc[:, -1:] - asc[:, :1]) / (N - 1)
    return bincrease, torch.cat([asc[:, :1] - step, asc], dim=1)


def _finish(cdf: torch.Tensor, bincrease: torch.Tensor, lt: bool):
    """Ascending (B, C, N) CDF -> the reference CDF (lt/gt flip, then the
    decreasing-bin re-pairing)."""
    if not lt:
        cdf = cdf[..., -1:] - cdf
    return torch.where(bincrease[:, None, :], cdf, cdf.flip(-1))


def _ascending_cdf(values, bins, weights_list):
    """One K2 launch: (ascending (B, C, N) CDF, bincrease (B, 1), batch
    shape) of the weights over the values, digitized once."""
    batch_shape = values.shape[:-2]
    G = values.shape[-2] * values.shape[-1]
    N = bins.shape[-1]
    vf = values.reshape(-1, G).contiguous()
    wf = torch.stack([torch.broadcast_to(w, values.shape).reshape(-1, G)
                      for w in weights_list], dim=1).contiguous()
    bf = torch.broadcast_to(bins, batch_shape + (N,)).reshape(-1, N)
    bincrease, edges = _edges(bf)
    return _k2.weighted_cdf(vf, edges.contiguous(), wf), bincrease, batch_shape


def weighted_cdf_multi(values: torch.Tensor, bins: torch.Tensor,
                       weights_list: Sequence[torch.Tensor],
                       lt: bool) -> List[torch.Tensor]:
    """Several weighted CDFs over the SAME values and bins in one pass (the
    Keff chain's area and |grad q|^2 integrals share one digitize).

    values : (..., Ny, Nx); bins : (N,) or (..., N); each weight
    broadcastable to ``values``.  Returns a list of (..., N) tensors."""
    asc, bincrease, batch_shape = _ascending_cdf(values, bins, weights_list)
    cdf = _finish(asc, bincrease, lt)
    return [cdf[:, c].reshape(batch_shape + (cdf.shape[-1],))
            for c in range(len(weights_list))]


def weighted_cdf_both(values: torch.Tensor, bins: torch.Tensor,
                      weights: torch.Tensor, lt: bool):
    """(the ``lt`` CDF, the ``not lt`` CDF) of one weight from one digitize:
    the two differ only in how the ascending CDF is finished."""
    asc, bincrease, batch_shape = _ascending_cdf(values, bins, [weights])
    return tuple(_finish(asc, bincrease, side)[:, 0].reshape(
        batch_shape + (asc.shape[-1],)) for side in (lt, not lt))


def weighted_cdf(values: torch.Tensor, bins: torch.Tensor,
                 weights: torch.Tensor, lt: bool) -> torch.Tensor:
    """Batched weighted-histogram CDF: (..., Ny, Nx) values, (N,) or
    (..., N) monotone bins, weights broadcastable to values -> (..., N)
    with ``out[..., k]`` paired with ``bins[..., k]``."""
    return weighted_cdf_multi(values, bins, [weights], lt)[0]
