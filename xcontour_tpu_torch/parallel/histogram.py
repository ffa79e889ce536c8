"""Sharded weighted-histogram CDF: the local CDF, then a sum over 'x'.

Counterpart of ``xcontour_tpu/parallel/histogram.py``.  Each rank bins
only its own x slab: one K2 launch on the card gives the slab's ascending
CDF (:func:`..ops.histogram._ascending_cdf`), the bins being replicated
and few (N ~ 10^2).  A sum all-reduce over the 'x' axis moves N floats a
snapshot and channel, and the finish (the lt/gt flip and the re-pairing
of decreasing bins) runs replicated.  The finish is linear, so this is
JAX's local bincount, ``psum``, ``cdf_from_hist`` in the same order.
Where a weight needs a gradient, the launch goes through the K2 Function
(:class:`..ops.histogram._WeightedCDF`), whose (B, N) channels are summed
in one all-reduce.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.histogram import _ascending_cdf, _finish
from . import _comm
from .mesh import X


def sharded_weighted_cdf_multi(values: torch.Tensor, bins: torch.Tensor,
                               weights_list: Sequence[torch.Tensor], lt: bool,
                               mesh: DeviceMesh) -> List[torch.Tensor]:
    """Several weighted CDFs over the same local values and bins, from one
    digitize (one K2 launch) and one all-reduce.

    values : the rank's (..., Ny, Nx_local) block; bins : (N,) or (..., N),
    replicated over 'x'; each weight broadcastable to the local block.
    Returns a list of (..., N) tensors, replicated over 'x'.  A weight's
    gradient is its cotangent on the rank's cells (JAX's ``psum`` of the
    local CDF, transposed); values and bins get none."""
    asc, bincrease, batch_shape = _ascending_cdf(values, bins, weights_list)
    asc = _comm.sum_(asc, mesh.get_group(X))
    return [c.reshape(batch_shape + (c.shape[-1],))
            for c in _finish(asc, bincrease, lt)]


def sharded_weighted_cdf(values: torch.Tensor, bins: torch.Tensor,
                         weights: torch.Tensor, lt: bool,
                         mesh: DeviceMesh) -> torch.Tensor:
    """Batched weighted CDF with the grid X axis sharded over 'x' (and the
    batch over 'batch', which needs no collective).

    values : the rank's (B_local, Ny, Nx_local) block; weights : its
    block, or anything broadcastable to it; bins : (N,) replicated.
    Returns (B_local, N), replicated over 'x'."""
    return sharded_weighted_cdf_multi(values, bins, [weights], lt, mesh)[0]
