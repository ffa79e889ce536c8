"""K1: the |grad q|^2 stencil (CUDA: ``csrc/stencil.cu``).

Replaces ``xcontour_tpu/kernels/stencil_pallas.py`` (``_kernel``, launched
by ``squared_gradient_pallas``).  Centered differences, periodic or
one-sided x walls, y walls per ``bc_y`` ('extend' one-sided, 'fill' zero
ghost rows, 'reflect' a zero wall-normal difference), spacings given as
reciprocals and multiplied.
The finite differences are shared with ``ops.stencil.gradient``.
"""

from __future__ import annotations

import torch

from . import Kernel, check_cuda_inputs, check_status, stream_handle

KERNEL = Kernel("squared_gradient", "xcontour_tpu_torch/csrc/stencil.cu",
                "xcontour_tpu/kernels/stencil_pallas.py:23")

_BC_Y = {"extend": 0, "fill": 1, "reflect": 2}


def _centered_x(q, periodic: bool):
    if periodic:
        return (torch.roll(q, -1, -1) - torch.roll(q, 1, -1)) * 0.5
    interior = (q[..., 2:] - q[..., :-2]) * 0.5
    first = q[..., 1:2] - q[..., 0:1]
    last = q[..., -1:] - q[..., -2:-1]
    return torch.cat([first, interior, last], dim=-1)


def _centered_y(q, bc: str = "extend"):
    interior = (q[..., 2:, :] - q[..., :-2, :]) * 0.5
    if bc == "extend":
        # replicate-pad then center == one-sided full difference at the walls
        first = q[..., 1:2, :] - q[..., 0:1, :]
        last = q[..., -1:, :] - q[..., -2:-1, :]
    elif bc == "reflect":
        # mirror-pad: the centered difference at the wall vanishes (NaN
        # where row 1 is not finite, as in the JAX package)
        first = (q[..., 1:2, :] - q[..., 1:2, :]) * 0.0
        last = first
    elif bc == "fill":
        # zero-pad: the ghost row is 0
        first = q[..., 1:2, :] * 0.5
        last = -q[..., -2:-1, :] * 0.5
    else:
        raise ValueError(f"unknown y boundary condition {bc!r}")
    return torch.cat([first, interior, last], dim=-2)


def squared_gradient_plain(q: torch.Tensor, rdx: torch.Tensor,
                           rdy: torch.Tensor, *, periodic_x: bool,
                           bc_y: str = "extend") -> torch.Tensor:
    """q (B, Ny, Nx); rdx (Ny, Nx) = 1/dx; rdy (Ny,) = 1/dy -> (B, Ny, Nx)."""
    gx = _centered_x(q, periodic_x) * rdx
    gy = _centered_y(q, bc_y) * rdy[:, None]
    return gx * gx + gy * gy


def squared_gradient(q: torch.Tensor, rdx: torch.Tensor, rdy: torch.Tensor,
                     *, periodic_x: bool, bc_y: str = "extend") -> torch.Tensor:
    """|grad q|^2 of q (B, Ny, Nx) given reciprocal spacings rdx (Ny, Nx)
    and rdy (Ny,).  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if q.device.type == "cpu":
        return squared_gradient_plain(q, rdx, rdy, periodic_x=periodic_x,
                                      bc_y=bc_y)
    if bc_y not in _BC_Y:
        raise ValueError(f"unknown y boundary condition {bc_y!r}")
    check_cuda_inputs(KERNEL.name, q=q, rdx=rdx, rdy=rdy)
    if q.dim() != 3:
        raise ValueError(f"{KERNEL.name}: q must be (B, Ny, Nx), got {tuple(q.shape)}")
    B, Ny, Nx = q.shape
    if Ny < 2 or Nx < 2:
        raise ValueError(f"{KERNEL.name}: the stencil needs Ny, Nx >= 2")
    if rdx.shape != (Ny, Nx) or rdy.shape != (Ny,):
        raise ValueError(f"{KERNEL.name}: rdx {tuple(rdx.shape)} / rdy "
                         f"{tuple(rdy.shape)} do not match ({Ny}, {Nx})")
    if q.numel() >= 2 ** 31:
        raise ValueError(f"{KERNEL.name}: more than 2^31 cells")
    from ._build import library
    out = torch.empty_like(q)
    status = library().xc_squared_gradient(
        q.data_ptr(), rdx.data_ptr(), rdy.data_ptr(), out.data_ptr(),
        B, Ny, Nx, int(periodic_x), _BC_Y[bc_y], stream_handle())
    check_status(KERNEL.name, status)
    KERNEL.count()
    return out
