"""K8's yardstick: the bytes and FP32 instructions of one launch of the
windowed local lengths over a batch of fields.

A frozen copy of ``chip_smoke.py``'s ``k8_crossed_cells`` and
``k8_instructions`` as they stood when the cell ``era5.local`` was added,
summed over the batch: a later change to the program cannot move the bound
K8 is measured against.  The windows' levels are their means, worked out
in float64 from the fields by the plain reference.
"""

from __future__ import annotations

import torch

from xcbench.reference.local import window_means
from xcbench.roofline_work import CLASSIFY_INSTR, SEGMENT_INSTR, corner_ranges

# the pretest of a (window, lattice block it covers) pair: its level
# against the block's [min, max), two compares
PRETEST_INSTR = 2


def k8_crossed_cells(q0, lv, window: int, stride: int) -> int:
    """Crossed cells of all windows of q0 (Ny, Nx) at their levels
    lv (Wy, Wx), a row of windows at a time."""
    lo, hi = corner_ranges(q0)
    cells, n = window - 1, 0
    for iy in range(lv.shape[0]):
        rows = slice(iy * stride, iy * stride + cells)
        lw = lo[rows].unfold(1, cells, stride)       # (cells, Wx, cells)
        hw = hi[rows].unfold(1, cells, stride)
        lev = lv[iy][None, :, None]
        n += int(((lw <= lev) & (lev < hw)).sum())
    return n


def k8_instructions(Ny, Nx, Wy, Wx, window, stride, pairs,
                    latlon: bool = True) -> int:
    """K8's least FP32 work on one field: CLASSIFY_INSTR for each field
    cell a window covers, PRETEST_INSTR for each (window, lattice block it
    covers) and SEGMENT_INSTR for each crossed (window, cell) pair; a
    window of window - 1 cells a side covers ceil((window - 1) / stride)
    blocks a side."""
    cells = window - 1
    covered = ((Wy - 1) * min(stride, cells) + cells) \
        * ((Wx - 1) * min(stride, cells) + cells)
    nbw = -(-cells // stride)
    return (CLASSIFY_INSTR * covered + PRETEST_INSTR * Wy * Wx * nbw ** 2
            + SEGMENT_INSTR[latlon] * pairs)


def k8_work(q, yc, xc, latlon, window: int, stride: int):
    """(bytes, FP32 instructions) of one K8 launch on q (B, Ny, Nx): the
    fields, the levels, the coordinates in and the totals out, 4 bytes
    each; each field's k8_instructions at its crossed cells."""
    B, Ny, Nx = q.shape
    lv = window_means(q.double(), window, stride)
    Wy, Wx = lv.shape[-2:]
    ops = 0
    if Wy and Wx:
        for b in range(B):
            pairs = k8_crossed_cells(q[b].double(), lv[b], window, stride)
            ops += k8_instructions(Ny, Nx, Wy, Wx, window, stride, pairs,
                                   bool(latlon))
    return 4 * (q.numel() + 2 * lv.numel() + yc.numel() + xc.numel()), ops
