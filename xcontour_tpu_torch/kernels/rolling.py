"""R: the window means of the windowed local lengths (CUDA:
``csrc/rolling.cu``).

For each (window x window) tile of a field (Ny, Nx), or of each field of
a batch (B, Ny, Nx), anchored every ``stride`` points, the mean of its
finite points; a window with fewer than ``min_count`` gives NaN.
:func:`window_means` is the wrapper: CPU tensors take the plain version,
integral images in O(grid); CUDA tensors one launch of the kernel, which
sums each window's points in float64 at its anchor, from the tiles
:func:`plan` lays out.

The kernel replaces no TPU kernel: the JAX package computes the window
means with plain jnp (``xcontour_tpu/diagnostics/local_length.py:28``),
and so does the plain version here, ~55 launches a call.
``tests/test_torch_rolling.py`` evaluates the kernel's sums, tile by tile
and in its order, in plain torch.
"""

from __future__ import annotations

import functools

import torch

from . import Kernel, check_status, stream_handle

KERNEL = Kernel(
    "window_means", "xcontour_tpu_torch/csrc/rolling.cu",
    "none: xcontour_tpu/diagnostics/local_length.py:28 is plain jnp")

# csrc/rolling.cu's block shapes, (threads a block, columns a thread: a
# template argument, in 16-byte units), the smallest first: a tile's
# footprint and the up to LEAD columns before it that its first unit
# loads fit in threads * columns, so a window has at most MAX_WINDOW
# points a side
SHAPES = ((64, 4), (128, 4), (256, 4), (256, 16))
LEAD = 3
MAX_WINDOW = SHAPES[-1][0] * SHAPES[-1][1] - LEAD
# blocks a launch should bring to fill the card's 132 SMs many times over
TARGET_BLOCKS = 8 * 132


def anchors(n: int, window: int, stride: int) -> int:
    """Windows along an axis of n points (0 for a window past the axis,
    as numpy's empty range)."""
    return len(range(0, max(0, n - window + 1), stride))


def window_means_plain(data: torch.Tensor, window: int, stride: int,
                       min_count: int = 1) -> torch.Tensor:
    """The plain version: integral images of the finite values and of
    their count, and each window's box sum.  The field's finite mean c0 is
    removed first: a box sum is a small difference of large cumsums, and in
    float32 a Kelvin-scale offset would leave ~1e-3 relative error in the
    mean; mean(f) = mean(f - c0) + c0 restores it (and is the value of a
    window with no finite point where ``min_count`` <= 0)."""
    good = torch.isfinite(data)
    nan = torch.full_like(data, float("nan"))
    c0 = torch.nanmean(torch.where(good, data, nan), dim=(-2, -1), keepdim=True)
    c0 = torch.where(torch.isfinite(c0), c0, torch.zeros_like(c0))
    vals = torch.where(good, data - c0, torch.zeros_like(data))

    def integral(a):
        s = torch.cumsum(torch.cumsum(a, dim=-2), dim=-1)
        return torch.nn.functional.pad(s, (1, 0, 1, 0))

    S = integral(vals)
    C = integral(good.to(data.dtype))
    ny, nx = data.shape[-2:]
    oy = torch.arange(0, max(0, ny - window + 1), stride, device=data.device)
    ox = torch.arange(0, max(0, nx - window + 1), stride, device=data.device)
    yy, xx = torch.meshgrid(oy, ox, indexing="ij")

    def box(I):
        return (I[..., yy + window, xx + window] - I[..., yy + window, xx]
                - I[..., yy, xx + window] + I[..., yy, xx])

    n = box(C)
    mean = box(S) / torch.clamp(n, min=1) + c0
    return torch.where(n >= min_count, mean,
                       torch.full_like(mean, float("nan")))


def field_fill(data: torch.Tensor) -> torch.Tensor:
    """The value of a window with no finite point where ``min_count`` <= 0,
    a field at a time (B,) float64: the field's finite mean, 0 for an
    all-NaN field (the plain version's c0)."""
    good = torch.isfinite(data)
    tot = torch.where(good, data, torch.zeros_like(data)).double().sum((-2, -1))
    n = good.sum((-2, -1))
    return torch.where(n > 0, tot / n.clamp(min=1), torch.zeros_like(tot))


@functools.lru_cache(maxsize=256)
def plan(B: int, Ny: int, Nx: int, window: int, stride: int):
    """The kernel's tiles: (TX, TY, ntx, nty, threads, cols, nch_max).  A
    block of ``threads`` takes TY anchor rows x TX anchors of one field
    and the footprint of (TX - 1) * stride + window columns they cover, a
    thread ``cols`` of them: the smallest block shape that leaves room for
    at least twice the window (the halo at most half the footprint).  The
    anchors across are cut evenly into ntx tiles of at most as many as
    fit, then the anchor rows into nty bands, enough for TARGET_BLOCKS
    blocks in all; nch_max is a tile's most chunks of ``stride`` columns
    (its shared memory)."""
    Wy, Wx = anchors(Ny, window, stride), anchors(Nx, window, stride)
    threads, cols = next((t, c) for t, c in SHAPES
                         if t * c - LEAD >= 2 * window or (t, c) == SHAPES[-1])
    fit = (threads * cols - LEAD - window) // stride + 1
    ntx = -(-Wx // fit)
    TX = -(-Wx // ntx)
    TY = max(1, Wy // -(-TARGET_BLOCKS // (B * ntx)))
    nty = -(-Wy // TY)
    return TX, TY, ntx, nty, threads, cols, TX + window // stride


def window_means(data: torch.Tensor, window: int, stride: int,
                 min_count: int = 1) -> torch.Tensor:
    """The window means (..., Wy, Wx) of data (..., Ny, Nx): of each
    (window x window) tile anchored every ``stride`` points, the mean of
    its finite points; NaN for fewer than ``min_count``, and where
    ``min_count`` <= 0 a tile with no finite point gives its field's finite
    mean (0 for an all-NaN field).  CPU tensors take the plain version;
    CUDA tensors (float32 or float64, contiguous) one launch a call, up to
    65,535 fields a launch: any window up to MAX_WINDOW and any stride,
    fewer than 2^31 points a field."""
    if data.device.type == "cpu":
        return window_means_plain(data, window, stride, min_count)
    name = KERNEL.name
    if data.device.type != "cuda":
        raise ValueError(f"{name}: data is on {data.device}")
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: data is {data.dtype}; the kernel takes "
                        "float32 or float64")
    if data.dim() < 2 or not data.is_contiguous():
        raise ValueError(f"{name}: data must be contiguous (..., Ny, Nx)")
    if data.requires_grad:
        raise RuntimeError(f"{name}: data requires grad; a kernel wrapper "
                           "records no graph: differentiate through "
                           "rolling_mean")
    if window < 1 or stride < 1:
        raise ValueError(f"{name}: window and stride must be >= 1")
    if window > MAX_WINDOW:
        raise ValueError(f"{name}: a window of {window} points; the kernel "
                         f"takes at most {MAX_WINDOW}")
    Ny, Nx = data.shape[-2:]
    if Ny * Nx >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 points a field")
    Wy, Wx = anchors(Ny, window, stride), anchors(Nx, window, stride)
    B = data.numel() // (Ny * Nx) if Ny * Nx else 0
    shape = data.shape[:-2] + (Wy, Wx)
    if B == 0 or Wy == 0 or Wx == 0:
        return data.new_zeros(shape)
    from ._build import library
    TX, TY, ntx, nty, threads, cols, nch = plan(B, Ny, Nx, window, stride)
    fill = field_fill(data.reshape(B, Ny, Nx)) if min_count <= 0 else None
    out = torch.empty(shape, dtype=data.dtype, device=data.device)
    status = library().xc_window_means(
        data.data_ptr(), None if fill is None else fill.data_ptr(),
        out.data_ptr(), B, Ny, Nx, Wy, Wx, window, stride, min_count,
        data.element_size(), TX, TY, ntx, nty, threads, cols, nch,
        stream_handle())
    check_status(name, status)
    KERNEL.count()
    return out
