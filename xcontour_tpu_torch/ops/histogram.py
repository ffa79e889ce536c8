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
from ..kernels import needs_grad


def _edges(bf: torch.Tensor):
    """(B, N) bins -> (bincrease (B, 1), ascending edges (B, N+1)) with the
    prepended bin."""
    N = bf.shape[-1]
    bincrease = bf[:, :1] < bf[:, -1:]
    asc = torch.where(bincrease, bf, bf.flip(-1))
    step = (asc[:, -1:] - asc[:, :1]) / (N - 1)
    return bincrease, torch.cat([asc[:, :1] - step, asc], dim=1)


def _finish_one(cdf: torch.Tensor, bincrease: torch.Tensor, lt: bool):
    if not lt:
        cdf = cdf[..., -1:] - cdf
    return torch.where(bincrease, cdf, cdf.flip(-1))


def _finish(asc, bincrease: torch.Tensor, lt: bool) -> List[torch.Tensor]:
    """Ascending CDFs -> the reference CDFs (lt/gt flip, then the
    decreasing-bin re-pairing), one (B, N) tensor per channel.  A (B, C, N)
    launch output is finished at once; a tuple of (B, N) channels (the
    outputs of :class:`_WeightedCDF`) each on its own, so that a channel
    no differentiated output uses gets no cotangent."""
    if isinstance(asc, tuple):
        return [_finish_one(a, bincrease, lt) for a in asc]
    return list(_finish_one(asc, bincrease[:, None, :], lt).unbind(1))


class _WeightedCDF(torch.autograd.Function):
    """K2 with the analytic weight cotangent (JAX:
    ``ops/histogram._pallas_cdf_multi_ad``).  Forward: one launch for all
    channels, one (B, N) output per channel.  Backward: the ascending CDF is
    linear in the weights, out[k] = sum of w over cells with bin <= k, so
    a weight's cotangent is the reverse cumulative sum of its channel's
    cotangent over levels, gathered at the cell's bin; zero on cells
    outside [e0, eN], NaN values and NaN weights.  Values and edges get
    none (the digitize is piecewise constant).  A channel whose output has
    no gradient gets None: its zeros are never made."""

    @staticmethod
    def forward(ctx, vf, edges, *wfs):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(vf, edges, *wfs)
        out = _k2.weighted_cdf(vf.detach(), edges.detach(),
                               torch.stack([w.detach() for w in wfs], dim=1))
        return tuple(c.clone() for c in out.unbind(1))

    @staticmethod
    def backward(ctx, *grads):
        vf, edges, *wfs = ctx.saved_tensors
        live = [c for c, g in enumerate(grads)
                if g is not None and ctx.needs_input_grad[2 + c]]
        out = [None] * len(wfs)
        if live:
            idx, valid = _k2.digitize(vf, edges)
            for c in live:
                g = grads[c]
                above = g.flip(-1).cumsum(-1).flip(-1)        # sum over k >= j
                cot = torch.gather(above, 1, idx)
                keep = valid & ~torch.isnan(wfs[c])
                out[c] = torch.where(keep, cot, torch.zeros_like(cot))
        return (None, None, *out)


def _ascending_cdf(values, bins, weights_list):
    """One K2 launch: (ascending CDFs, bincrease (B, 1), batch shape) of
    the weights over the values, digitized once.  Where a weight needs a
    gradient the launch goes through :class:`_WeightedCDF` (a tuple of
    (B, N) channels); otherwise the wrapper is called directly ((B, C, N))."""
    batch_shape = values.shape[:-2]
    G = values.shape[-2] * values.shape[-1]
    N = bins.shape[-1]
    vf = values.reshape(-1, G).contiguous()
    wfs = [torch.broadcast_to(w, values.shape).reshape(-1, G)
           for w in weights_list]
    bf = torch.broadcast_to(bins, batch_shape + (N,)).reshape(-1, N)
    bincrease, edges = _edges(bf)
    edges = edges.contiguous()
    if needs_grad(*wfs):
        asc = _WeightedCDF.apply(vf, edges, *(w.contiguous() for w in wfs))
    else:
        asc = _k2.weighted_cdf(vf.detach(), edges.detach(),
                               torch.stack(wfs, dim=1).contiguous().detach())
    return asc, bincrease, batch_shape


def weighted_cdf_multi(values: torch.Tensor, bins: torch.Tensor,
                       weights_list: Sequence[torch.Tensor],
                       lt: bool) -> List[torch.Tensor]:
    """Several weighted CDFs over the SAME values and bins in one pass (the
    Keff chain's area and |grad q|^2 integrals share one digitize).

    values : (..., Ny, Nx); bins : (N,) or (..., N); each weight
    broadcastable to ``values``.  Returns a list of (..., N) tensors."""
    asc, bincrease, batch_shape = _ascending_cdf(values, bins, weights_list)
    return [c.reshape(batch_shape + (c.shape[-1],))
            for c in _finish(asc, bincrease, lt)]


def weighted_cdf_stacked(values: torch.Tensor, bins: torch.Tensor, stacked,
                         lt: bool) -> List[torch.Tensor]:
    """:func:`weighted_cdf_multi` of weights already stacked as K2 reads
    them, (..., C, Ny, Nx) over values (..., Ny, Nx): one launch on the
    stack as it is, with no broadcast or stack of its own (the
    contour-length chain's five, written by G).  Where the stack needs a
    gradient its channels go through :class:`_WeightedCDF` one by one, as
    :func:`weighted_cdf_multi` sends them; so does a tuple of the C
    (..., Ny, Nx) channels (the form that keeps a channel no
    differentiated output uses free of cotangents).  Returns a list of C
    (..., N) tensors."""
    batch_shape = values.shape[:-2]
    G = values.shape[-2] * values.shape[-1]
    N = bins.shape[-1]
    vf = values.reshape(-1, G).contiguous()
    bf = torch.broadcast_to(bins, batch_shape + (N,)).reshape(-1, N)
    bincrease, edges = _edges(bf)
    edges = edges.contiguous()
    if isinstance(stacked, tuple) or needs_grad(stacked):
        chans = stacked if isinstance(stacked, tuple) else stacked.unbind(-3)
        asc = _WeightedCDF.apply(vf, edges, *(w.reshape(-1, G).contiguous()
                                              for w in chans))
    else:
        asc = _k2.weighted_cdf(vf.detach(), edges.detach(), stacked.reshape(
            -1, stacked.shape[-3], G).contiguous().detach())
    return [c.reshape(batch_shape + (c.shape[-1],))
            for c in _finish(asc, bincrease, lt)]


def weighted_cdf_both(values: torch.Tensor, bins: torch.Tensor,
                      weights: torch.Tensor, lt: bool):
    """(the ``lt`` CDF, the ``not lt`` CDF) of one weight from one digitize:
    the two differ only in how the ascending CDF is finished."""
    asc, bincrease, batch_shape = _ascending_cdf(values, bins, [weights])
    return tuple(c.reshape(batch_shape + (c.shape[-1],))
                 for side in (lt, not lt)
                 for c in _finish(asc, bincrease, side))


def weighted_cdf(values: torch.Tensor, bins: torch.Tensor,
                 weights: torch.Tensor, lt: bool) -> torch.Tensor:
    """Batched weighted-histogram CDF: (..., Ny, Nx) values, (N,) or
    (..., N) monotone bins, weights broadcastable to values -> (..., N)
    with ``out[..., k]`` paired with ``bins[..., k]``."""
    return weighted_cdf_multi(values, bins, [weights], lt)[0]
