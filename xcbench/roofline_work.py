"""The yardstick of the kernels' roofline shares: each kernel's bytes and
FP32 instructions, and the H100 SXM's published peaks.

A frozen copy of the work functions of ``xcontour_tpu_torch/utils/
roofline.py`` as they stood when the benchmark was defined: a later change
to the program cannot move the bound its kernels are measured against.
Each input is counted once and each output once, whatever a kernel reads
again; K7's instructions count the (cell, level) pairs the inputs cross.
"""

from __future__ import annotations

import torch

# the H100 SXM's published peaks at 700 W: HBM bytes/s, and FP32
# instructions/s (67 TFLOP/s with an FMA counted twice)
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 33.5e12
# K7's FP32 instructions: 6 to classify a cell (its corners' min and max),
# and for each crossed (cell, level) pair its segment: two edge points of 5
# each and the segment, 22 on the sphere (haversine) or 3 in the plane
# (hypot).  A math-library call or an IEEE division counts as one
# instruction and a saddle's second segment not at all: lower bounds.
CLASSIFY_INSTR = 6
SEGMENT_INSTR = {True: 32, False: 13}


def lwa_work(B, Ny, Nx, pairs=None):
    """(bytes, FP32 instructions) of an LWA kernel: q, W, Q in, the field
    out; 3 instructions (sub, min/max, FMA) per (surface, cell) pair."""
    pairs = B * Ny * Ny * Nx if pairs is None else pairs
    return 4 * (2 * B * Ny * Nx + Ny * Nx + B * Ny), 3 * pairs


def stencil_work(B, Ny, Nx):
    """(bytes, FP32 instructions) of K1: q in, the field out, 1/dx and
    1/dy once; 6 instructions a cell."""
    cells = B * Ny * Nx
    return 4 * (2 * cells + Ny * Nx + Ny), 6 * cells


def cdf_work(B, G, N, C, out=None):
    """(bytes, FP32 instructions) of K2: values, C weight channels and N+1
    edges in, the (B, C, N) CDF out; one add per (cell, channel)."""
    out = B * C * N if out is None else out
    return 4 * (B * G * (1 + C) + B * (N + 1) + out), B * C * G


def bound_ms(work):
    """(bound ms, what bounds it) of (bytes, instructions)."""
    nbytes, ops = work
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def corner_ranges(q):
    """[lo, hi) of each cell's corners, (..., Ny - 1, Nx - 1): a level
    crosses a cell exactly when lo <= level < hi; (inf, -inf) for a cell
    with a NaN corner."""
    c = torch.stack([q[..., :-1, :-1], q[..., :-1, 1:], q[..., 1:, :-1],
                     q[..., 1:, 1:]])
    bad = torch.isnan(c).any(0)
    inf = torch.full_like(c[0], float("inf"))
    return (torch.where(bad, inf, c.amin(0)),
            torch.where(bad, -inf, c.amax(0)))


def k7_crossed_pairs(q, levels):
    """Crossed (cell, level) pairs of data (B, Ny, Nx) at levels (B, N)."""
    lo, hi = corner_ranges(q)
    B = q.shape[0]
    srt = torch.sort(levels, dim=-1).values.contiguous()      # NaN last
    a = torch.searchsorted(srt, lo.reshape(B, -1).contiguous())
    e = torch.searchsorted(srt, hi.reshape(B, -1).contiguous())
    return int((e - a).clamp(min=0).sum())


def k7_work(q, levels, yc, xc, latlon, pairs=None, out=None):
    """(bytes, FP32 instructions) of K7: the field, levels and coordinates
    in, the (B, N) totals out; CLASSIFY_INSTR a cell and SEGMENT_INSTR a
    crossed pair (counted from the inputs unless given)."""
    if pairs is None:
        pairs = k7_crossed_pairs(q, levels)
    out = levels.numel() if out is None else out
    return (4 * (q.numel() + levels.numel() + out + yc.numel() + xc.numel()),
            CLASSIFY_INSTR * q.numel() + SEGMENT_INSTR[latlon] * pairs)
