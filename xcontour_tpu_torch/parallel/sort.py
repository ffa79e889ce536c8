"""Sharded exact (sort-based) conditional integrals: local sort, then a
sum over 'x'.

Counterpart of ``xcontour_tpu/parallel/sort.py``.  The conditional sum
F(c) = sum over q <lt/gt> c of w splits across slabs, so each rank sorts
only its own x slab (:func:`..ops.sort.exact_conditional_integral`: sort,
prefix sums, a search at the levels) and one sum all-reduce of the N
level sums a snapshot over the 'x' axis gives the exact global answer: no
global sort, values never leave their rank.  Within a slab the order of
the sum is the sorted order; across slabs the all-reduce adds one partial
a rank, so the result differs from one card's by the reassociation of
those partial sums.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.sort import exact_conditional_integral
from . import _comm
from .mesh import X


def sharded_exact_conditional_integral(
        values: torch.Tensor, bins: torch.Tensor, weights: torch.Tensor,
        lt: bool, mesh: DeviceMesh) -> torch.Tensor:
    """Batched exact F(c) with the grid X axis sharded over 'x'.

    values : the rank's (B_local, Ny, Nx_local) block; weights : its block
    or broadcastable to it; bins : (N,) replicated or (B_local, N).
    Returns (B_local, N), replicated over 'x'."""
    part = exact_conditional_integral(values, bins, weights, lt)
    return _comm.sum_(part, mesh.get_group(X))
