"""E: the contour levels' scan (CUDA: ``csrc/extrema.cu``).

Replaces no TPU kernel: ``xcontour_tpu/core.py:45-63`` is plain jnp.  The
plain version is that chain: each snapshot's min and max over its plane
with NaN cells skipped (``where(isnan, +-inf, q)``, then ``amin`` and
``amax``), and N evenly spaced levels between them, the last pinned to
the extremum.  The kernel reads the tracer once and writes the levels, or
in its extrema mode the (min, max) pair with the infinities kept, bit for
bit with the plain version.  It takes float32 and float64 (templated on
the cell type; the dtypes the tracer comes in), and no other dtype.
"""

from __future__ import annotations

import torch

from . import Kernel, check_status, device_constant, stream_handle

KERNEL = Kernel("contour_levels", "xcontour_tpu_torch/csrc/extrema.cu",
                "none: xcontour_tpu/core.py:45-63 is plain jnp")

# the first launch's blocks: as K2's first pass cuts its planes
# (hist.blocks_a_plane), with at least MIN_CELLS cells a block
MIN_CELLS = 8192


def masked_extrema_plain(x: torch.Tensor):
    """(min, max) of each snapshot of x (..., Ny, Nx) over its plane with
    NaN cells skipped: +inf and -inf where every cell is NaN."""
    isn = torch.isnan(x)
    inf = device_constant("inf", x.dtype, x.device)
    return (torch.where(isn, inf, x).amin(dim=(-2, -1)),
            torch.where(isn, -inf, x).amax(dim=(-2, -1)))


def levels_plain(mmin: torch.Tensor, mmax: torch.Tensor, N: int, *,
                 increase: bool = True) -> torch.Tensor:
    """N evenly spaced levels (..., N) between the extrema of
    :func:`masked_extrema_plain`, min->max if ``increase`` else max->min,
    the last pinned to the far extremum; NaN where an extremum is
    infinite (an all-NaN snapshot)."""
    inf = device_constant("inf", mmin.dtype, mmin.device)
    nan = device_constant("nan", mmin.dtype, mmin.device)
    mmin = torch.where(mmin == inf, nan, mmin)
    mmax = torch.where(mmax == -inf, nan, mmax)
    start, end = (mmin, mmax) if increase else (mmax, mmin)
    # a true division on every device: CUDA divides by a Python scalar
    # through its reciprocal, an ulp away from the CPU's (and XLA's) levels
    steps = (end - start) / torch.full_like(end, N - 1.0)
    levels = (steps[..., None] * torch.arange(N, dtype=mmin.dtype,
                                              device=mmin.device)
              + start[..., None])
    levels[..., -1] = end
    return levels


def contour_levels_plain(x: torch.Tensor, N: int, *,
                         increase: bool = True) -> torch.Tensor:
    """x (B, Ny, Nx) -> its levels (B, N)."""
    return levels_plain(*masked_extrema_plain(x), N, increase=increase)


def _check(x: torch.Tensor, N=None) -> None:
    name = KERNEL.name
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x is on {x.device}, not CUDA")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: x is {x.dtype}; the kernel takes float32 "
                        "or float64")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous (B, Ny, Nx), got "
                         f"{tuple(x.shape)}")
    if x.requires_grad:
        raise RuntimeError(f"{name}: x requires grad; a kernel wrapper "
                           "records no graph: differentiate through "
                           "core.cal_contours or core.masked_extrema")
    if x.shape[1] * x.shape[2] == 0:
        raise ValueError(f"{name}: a plane of no cells has no extrema")
    if x.shape[1] * x.shape[2] >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 cells a plane")
    if N is not None and N < 1:
        raise ValueError(f"{name}: N = {N}; at least one level")


def _launch(x: torch.Tensor, out: torch.Tensor, N: int, increase: bool,
            levels: bool) -> torch.Tensor:
    from ._build import library
    from .hist import _sm_count, blocks_a_plane
    B, M = x.shape[0], x.shape[1] * x.shape[2]
    if B == 0:
        return out
    chunks = blocks_a_plane(B, M, _sm_count(x.device.index), MIN_CELLS)
    partial = torch.empty((B, chunks, 2), dtype=x.dtype, device=x.device)
    status = library().xc_contour_levels(
        x.data_ptr(), partial.data_ptr(), out.data_ptr(), B, M, chunks, N,
        int(increase), int(levels), x.element_size(), stream_handle())
    check_status(KERNEL.name, status)
    KERNEL.count()
    return out


def contour_levels(x: torch.Tensor, N: int, *,
                   increase: bool = True) -> torch.Tensor:
    """The N levels (B, N) of x (B, Ny, Nx), as
    :func:`contour_levels_plain`.  CPU tensors take the plain version;
    CUDA tensors one call of the kernel (two launches)."""
    if x.device.type == "cpu":
        return contour_levels_plain(x, N, increase=increase)
    _check(x, N)
    out = torch.empty((x.shape[0], N), dtype=x.dtype, device=x.device)
    return _launch(x, out, N, increase, True)


def masked_extrema(x: torch.Tensor):
    """(min (B,), max (B,)) of x (B, Ny, Nx), as
    :func:`masked_extrema_plain`.  CPU tensors take the plain version;
    CUDA tensors one call of the kernel in its extrema mode."""
    if x.device.type == "cpu":
        return masked_extrema_plain(x)
    _check(x)
    out = torch.empty((2, x.shape[0]), dtype=x.dtype, device=x.device)
    _launch(x, out, 0, True, False)
    return out[0], out[1]
