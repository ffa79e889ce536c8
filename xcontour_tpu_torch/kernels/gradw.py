"""G: the contour-length chain's five CDF weights (CUDA: ``csrc/gradw.cu``).

Replaces no TPU kernel: ``xcontour_tpu/pipeline.py:251-273`` forms the
weights in plain jnp, from the gradient of ``ops.stencil.gradient``:

    dA, grdS dA, (grdm grdm) dA, grdm dA, ((1 / grdm) grdm) dA

with grdS = qx^2 + qy^2 and grdm = sqrt(grdS), the last three the
numerators and denominator of ``core.cal_contour_mean_hist``'s
(f * grdm) * dA; NaN in the last channel where grdm is 0.  One pass
writes them as the (B, 5, Ny, Nx) stack K2 reads.  The plain version is
that chain: centered differences (K1's, ``_centered_x`` and
``_centered_y``) divided by dx and dy, each operation rounded on its own.
"""

from __future__ import annotations

import torch

from . import Kernel, check_cuda_inputs, check_status, stream_handle
from .stencil import _BC_Y, _centered_x, _centered_y

KERNEL = Kernel("clength_weights", "xcontour_tpu_torch/csrc/gradw.cu",
                "none: xcontour_tpu/pipeline.py:251-273 is plain jnp")

CHANNELS = 5


def channels(q: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
             dA: torch.Tensor, *, periodic_x: bool,
             bc_y: str = "extend") -> list:
    """The five weights of q (..., Ny, Nx) as the chain forms them, dA
    first and unbroadcast; dx and dA (Ny, Nx), dy (Ny,)."""
    qx = _centered_x(q, periodic_x) / dx
    qy = _centered_y(q, bc_y) / dy[:, None]
    grdS = qx * qx + qy * qy
    grdm = torch.sqrt(grdS)
    return [dA, grdS * dA, (grdm * grdm) * dA, grdm * dA,
            ((1.0 / grdm) * grdm) * dA]


def clength_weights_plain(q: torch.Tensor, dx: torch.Tensor,
                          dy: torch.Tensor, dA: torch.Tensor, *,
                          periodic_x: bool,
                          bc_y: str = "extend") -> torch.Tensor:
    """q (B, Ny, Nx); dx, dA (Ny, Nx); dy (Ny,) -> (B, 5, Ny, Nx)."""
    return torch.stack([torch.broadcast_to(w, q.shape) for w in channels(
        q, dx, dy, dA, periodic_x=periodic_x, bc_y=bc_y)], dim=1)


def clength_weights(q: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                    dA: torch.Tensor, *, periodic_x: bool,
                    bc_y: str = "extend") -> torch.Tensor:
    """The five weights of q (B, Ny, Nx) stacked as (B, 5, Ny, Nx), given
    the spacings dx (Ny, Nx) and dy (Ny,) and the cell areas dA (Ny, Nx).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return clength_weights_plain(q, dx, dy, dA, periodic_x=periodic_x,
                                     bc_y=bc_y)
    if bc_y not in _BC_Y:
        raise ValueError(f"unknown y boundary condition {bc_y!r}")
    check_cuda_inputs(KERNEL.name, q=q, dx=dx, dy=dy, dA=dA)
    if q.dim() != 3:
        raise ValueError(f"{KERNEL.name}: q must be (B, Ny, Nx), got {tuple(q.shape)}")
    B, Ny, Nx = q.shape
    if Ny < 2 or Nx < 2:
        raise ValueError(f"{KERNEL.name}: the stencil needs Ny, Nx >= 2")
    if dx.shape != (Ny, Nx) or dA.shape != (Ny, Nx) or dy.shape != (Ny,):
        raise ValueError(f"{KERNEL.name}: dx {tuple(dx.shape)} / dy "
                         f"{tuple(dy.shape)} / dA {tuple(dA.shape)} do not "
                         f"match ({Ny}, {Nx})")
    if q.numel() >= 2 ** 31:
        raise ValueError(f"{KERNEL.name}: more than 2^31 cells")
    from ._build import library
    out = torch.empty((B, CHANNELS, Ny, Nx), dtype=q.dtype, device=q.device)
    status = library().xc_clength_weights(
        q.data_ptr(), dx.data_ptr(), dy.data_ptr(), dA.data_ptr(),
        out.data_ptr(), B, Ny, Nx, int(periodic_x), _BC_Y[bc_y],
        stream_handle())
    check_status(KERNEL.name, status)
    KERNEL.count()
    return out
