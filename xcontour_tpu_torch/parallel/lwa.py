"""Sharded LWA: each rank reduces its own longitude slab, with no
collective.

Counterpart of ``xcontour_tpu/parallel/lwa.py``.  The LWA surface
reduction runs along y with weights local to each column, so an x-sharded
field needs no communication: the sorted profile Q and the coordinates are
replicated (O(Ny)).  The weight's normalization needs the GLOBAL area
maximum, wei = dA / nanmax(dA) (reference core.py:723-724), so the weight
is composed from the whole dA before each rank takes its columns.  On the
card the local call launches K3 ('auto'/'lin'), K5 (LWA2 'lin') or K4
('dense' and part selections) on the slab, through their autograd
Function where an input needs a gradient.  The gradient of a replicated
input (Q, dA, a weight) on a rank is its slab's share: the shares add up
over 'x' to ``jax.grad``'s, as the pipelines' collectives add them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..diagnostics import lwa as _lwa
from .mesh import x_block


def _sharded(q, Q, dA, ydef, mesh, increase, part, weight, method, variant2):
    if weight is None:
        weight = dA / _lwa.nanmax(dA) * dA
    nxl = q.shape[-1]
    fn = _lwa.local_wave_activity2 if variant2 else _lwa.local_wave_activity
    return fn(q, Q, x_block(mesh, dA, nxl), ydef, increase=increase,
              part=part, weight=x_block(mesh, weight, nxl),
              method=method)


def sharded_local_wave_activity(q: torch.Tensor, Q: torch.Tensor,
                                dA: torch.Tensor, ydef: torch.Tensor,
                                mesh: DeviceMesh, *, increase: bool,
                                part: str = "all",
                                weight: Optional[torch.Tensor] = None,
                                method: str = "auto") -> torch.Tensor:
    """LWA of the rank's block.

    q : (B_local, Ny, Nx_local); Q : (B_local, Ny), replicated over 'x';
    dA : the whole (Ny, Nx) cell areas, replicated; ydef : (Ny,).
    ``weight`` (whole, (Ny, Nx)) replaces the default wei*dA, as in
    :func:`..diagnostics.lwa.local_wave_activity`.  Returns the LWA block
    (B_local, Ny, Nx_local)."""
    return _sharded(q, Q, dA, ydef, mesh, increase, part, weight, method,
                    False)


def sharded_local_wave_activity2(q: torch.Tensor, Q: torch.Tensor,
                                 dA: torch.Tensor, ydef: torch.Tensor,
                                 mesh: DeviceMesh, *, increase: bool,
                                 part: str = "all",
                                 weight: Optional[torch.Tensor] = None,
                                 method: str = "auto") -> torch.Tensor:
    """The impulse-Casimir LWA2 of the rank's block, arguments as in
    :func:`sharded_local_wave_activity` (K5 for 'auto'/'lin')."""
    return _sharded(q, Q, dA, ydef, mesh, increase, part, weight, method,
                    True)
