"""Derivative along the uniform contour index.

Counterpart of ``xcontour_tpu/ops/gradient.py``: xarray's
``.differentiate('contour')`` on the 0..N-1 contour coordinate, i.e.
``np.gradient`` with unit spacing (centered interior, one-sided edges).
"""

from __future__ import annotations

import torch


def gradient_index(var: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """np.gradient(var, axis=dim) with unit spacing."""
    v = torch.movedim(var, dim, -1)
    interior = (v[..., 2:] - v[..., :-2]) * 0.5
    first = v[..., 1:2] - v[..., 0:1]
    last = v[..., -1:] - v[..., -2:-1]
    out = torch.cat([first, interior, last], dim=-1)
    return torch.movedim(out, -1, dim)
