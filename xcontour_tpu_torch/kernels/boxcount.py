"""B: box-counting crossing lengths (CUDA: ``csrc/boxcount.cu``).

For each stride s, every box of (s+1) x (s+1) points advancing by s adds
sqrt(area) * s to each level its points' NaN-skipping [min, max) holds.
:func:`box_counts` takes the field and the areas already padded in x (by
the largest stride, ``diagnostics.length._pad_x``) and computes every
stride of a call: CPU tensors take the plain version, CUDA tensors one
launch of the kernel, from the launch table :func:`plan` builds.

The kernel replaces no TPU kernel: the JAX package computes box counting
with plain jnp (``xcontour_tpu/diagnostics/length.py:249``), and so does
the plain version here, ~60 launches a stride.
``tests/test_torch_length.py`` evaluates the launch table in plain torch.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import Kernel, check_cuda_inputs, check_status, stream_handle, vjp

KERNEL = Kernel("box_counts", "xcontour_tpu_torch/csrc/boxcount.cu",
                "none: xcontour_tpu/diagnostics/length.py:249 is plain jnp")

# csrc/boxcount.cu's limits: strides a launch, boxes a block's tile, and
# about the most points a tile's boxes read
MAX_STRIDES = 32
TILE_BOXES = 2048
TILE_POINTS = 16384
# a row of the launch table: the stride, its column of the output, box
# rows, box columns, a tile's box columns (T) and rows (R), tiles across,
# tiles a field, the stride's first block
TABLE_COLS = 9

# contour levels a step of the plain version's crossing sums: bounds its
# (..., chunk, boxes) temporaries
_CHUNK = 16


def boxes(Ny: int, W: int, s: int, quirks: bool):
    """(box rows, box columns) of stride s on a field padded to (Ny, W):
    the reference's round(Ny / s) - 1 rows and round(W / s) - 1 columns,
    or under ``quirks`` as many columns as rows."""
    Jn = int(np.round(Ny / s))
    In = int(np.round(W / s))
    return max(0, Jn - 1), max(0, (Jn - 1) if quirks else (In - 1))


@functools.lru_cache(maxsize=64)
def plan(strides: Tuple[int, ...], B: int, Ny: int, W: int,
         quirks: bool) -> np.ndarray:
    """The kernel's launch table (S, TABLE_COLS) int32, one row a stride in
    block order (the largest stride first).  A tile holds at most
    TILE_BOXES boxes and TILE_POINTS // (s+1)^2 of stride s (at least
    one), as many box columns as fit (the columns cut evenly), then rows;
    a stride without boxes still takes one (empty) tile a field, which
    writes its zeros.  Cached, so read-only."""
    rows = []
    order = sorted(range(len(strides)), key=lambda j: -strides[j])
    first = 0
    for j in order:
        s = strides[j]
        nrows, ncols = boxes(Ny, W, s, quirks)
        budget = min(TILE_BOXES, max(1, TILE_POINTS // (s + 1) ** 2))
        ntc = max(1, -(-ncols // budget))
        T = max(1, -(-ncols // ntc))
        R = max(1, budget // T)
        nbf = max(1, -(-nrows // R)) * ntc
        rows.append((s, j, nrows, ncols, T, R, ntc, nbf, first))
        first += B * nbf
    table = np.array(rows, dtype=np.int32).reshape(-1, TABLE_COLS)
    table.flags.writeable = False
    return table


def _window_minmax(data: torch.Tensor, stride: int):
    """NaN-skipping (min, max) over (stride+1) x (stride+1) windows
    advancing by stride; an all-NaN window gives (+inf, -inf).  NaN is
    replaced by +-inf first: torch's reductions propagate it."""
    nan = torch.isnan(data)
    lo = torch.where(nan, torch.full_like(data, float("inf")), data)
    hi = torch.where(nan, torch.full_like(data, float("-inf")), data)

    def windows(a):
        return a.unfold(-2, stride + 1, stride).unfold(-2, stride + 1, stride)
    return windows(lo).amin(dim=(-2, -1)), windows(hi).amax(dim=(-2, -1))


def box_counts_stride(d, contours, a, stride: int, quirks: bool):
    """The plain version at one stride: d (..., Ny, W) and a (Ny, W)
    padded; returns (..., N)."""
    batch = d.shape[:-2]
    jj, nn = d.shape[-2:]
    nrows, i_bound = boxes(jj, nn, stride, quirks)
    # the reference's quirks loop can ask for more column boxes than the
    # padded width holds (its numpy slices clamp, core.py:1545-1550); NaN
    # columns make the NaN-skipping windows reproduce the clamped blocks
    extra = max(0, i_bound * stride + 1 - nn)
    if extra:
        d = torch.cat([d, d.new_full(d.shape[:-1] + (extra,), float("nan"))], -1)
        a = torch.cat([a, a.new_full(a.shape[:-1] + (extra,), float("nan"))], -1)
    wmin, wmax = _window_minmax(d, stride)
    wmin = wmin[..., :nrows, :i_bound]
    wmax = wmax[..., :nrows, :i_bound]
    if quirks:
        a_box = a[:nrows, :i_bound]    # the reference indexes area by box
    else:
        a_box = a[::stride, ::stride][:nrows, :i_bound]
    contrib = torch.sqrt(a_box) * stride
    contrib = torch.where(torch.isnan(contrib), torch.zeros_like(contrib),
                          contrib)
    ctr = torch.broadcast_to(contours, batch + contours.shape[-1:])
    zero = torch.zeros((), dtype=contrib.dtype, device=contrib.device)
    outs = []
    for k in range(0, ctr.shape[-1], _CHUNK):
        c = ctr[..., k:k + _CHUNK, None, None]          # (..., c, 1, 1)
        crossing = (wmin[..., None, :, :] <= c) & (wmax[..., None, :, :] > c)
        outs.append(torch.where(crossing, contrib, zero).sum(dim=(-2, -1)))
    return torch.cat(outs, dim=-1)


def box_counts_plain(d, contours, a, strides: Sequence[int],
                     quirks: bool) -> torch.Tensor:
    """The plain version: a stride at a time, stacked to (..., N, S)."""
    return torch.stack([box_counts_stride(d, contours, a, int(s), quirks)
                        for s in strides], dim=-1)


def box_counts_vjp(d, contours, a, g, strides: Sequence[int], quirks: bool):
    """The cotangent of the padded areas ``a`` for the cotangent g
    (..., N, S) of :func:`box_counts_plain`, a stride at a time (the only
    input with a gradient: the crossings are comparisons)."""
    pieces = [(lambda p, s=int(s): box_counts_stride(p[0], p[1], p[2], s,
                                                     quirks), g[..., j])
              for j, s in enumerate(strides)]
    return vjp(pieces, (d, contours, a), (False, False, True))[2]


def _levels(contours: torch.Tensor, batch) -> torch.Tensor:
    """The level of each field, batch + (N,), as the plain version
    broadcasts ``contours`` against the fields: level k of a field is
    ctr[..., k] broadcast to the batch, ctr being ``contours`` broadcast
    to batch + its last axis (a 0-d level thus gives N = the last batch
    size, all levels equal)."""
    ctr = torch.broadcast_to(contours, batch + contours.shape[-1:])
    N = ctr.shape[-1]
    lead = (1,) * (len(batch) - (ctr.dim() - 1))
    per = ctr.movedim(-1, 0).reshape((N,) + lead + ctr.shape[:-1])
    return torch.broadcast_to(per, (N,) + batch).movedim(0, -1)


def box_counts(data: torch.Tensor, contours: torch.Tensor, area: torch.Tensor,
               strides: Sequence[int], *, quirks: bool = False
               ) -> torch.Tensor:
    """Box-counting crossing lengths (..., N, S) of data (..., Ny, W) at
    the levels ``contours`` ((N,) or (..., N)) for each stride of
    ``strides``, with ``area`` (Ny, W) the cell areas; data and area
    already padded in x by the largest stride.  CPU tensors take the plain
    version; CUDA tensors (float32, contiguous) one launch for every
    stride: Ny >= s + 1, at most MAX_STRIDES strides and fewer than 2^31
    points."""
    strides = tuple(int(s) for s in strides)
    if data.device.type == "cpu":
        return box_counts_plain(data, contours, area, strides, quirks)
    name = KERNEL.name
    if data.dim() < 2 or area.shape != data.shape[-2:]:
        raise ValueError(f"{name}: expected data (..., Ny, W) and area "
                         f"(Ny, W), got {tuple(data.shape)}, "
                         f"{tuple(area.shape)}")
    batch = data.shape[:-2]
    Ny, W = data.shape[-2:]
    if not 1 <= len(strides) <= MAX_STRIDES or min(strides) < 1:
        raise ValueError(f"{name}: 1 to {MAX_STRIDES} strides of at least 1, "
                         f"got {strides}")
    if Ny < max(strides) + 1 or W < max(strides) + 1:
        raise ValueError(f"{name}: a ({Ny}, {W}) field has no box of stride "
                         f"{max(strides)}")
    if data.numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 points")
    levels = _levels(contours, batch)
    N = levels.shape[-1]
    B = data.numel() // (Ny * W)
    levels = levels.reshape(B, N).contiguous()
    check_cuda_inputs(name, data=data, levels=levels, area=area)
    S = len(strides)
    if B == 0 or N == 0:
        return levels.new_zeros(batch + (N, S))
    from ._build import library
    table = plan(strides, B, Ny, W, bool(quirks))
    blocks = int(table[-1, 8]) + B * int(table[-1, 7])
    partial = torch.empty((blocks * N,), dtype=data.dtype, device=data.device)
    count = torch.empty((B * S,), dtype=torch.int32, device=data.device)
    out = torch.empty((B, N, S), dtype=data.dtype, device=data.device)
    status = library().xc_box_counts(
        data.data_ptr(), area.data_ptr(), levels.data_ptr(),
        partial.data_ptr(), count.data_ptr(), out.data_ptr(), B, Ny, W, N,
        S, int(quirks), table.ctypes.data, blocks, stream_handle())
    check_status(name, status)
    KERNEL.count()
    return out.reshape(batch + (N, S))
