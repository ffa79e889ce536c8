"""Block-coarsening of plane fields (counterpart of
``xcontour_tpu/utils/coarsen.py``): the NaN-skipping block mean of the last
two axes by an integer ratio, like xarray's coarsen(...).mean()."""

from __future__ import annotations

import torch


def coarsen(field: torch.Tensor, ratio: int) -> torch.Tensor:
    """Block-average the trailing (Ny, Nx) axes by ``ratio``, which must
    divide both.  NaNs are skipped; an all-NaN block gives NaN."""
    if ratio == 1:
        return field
    *batch, ny, nx = field.shape
    if ny % ratio or nx % ratio:
        raise ValueError(f"grid {ny}x{nx} not divisible by ratio {ratio}")
    blocks = field.reshape(*batch, ny // ratio, ratio, nx // ratio, ratio)
    s = torch.nansum(blocks, dim=(-3, -1))
    n = (~torch.isnan(blocks)).sum(dim=(-3, -1))
    return torch.where(n > 0, s / torch.clamp(n, min=1),
                       torch.full_like(s, float("nan")))
