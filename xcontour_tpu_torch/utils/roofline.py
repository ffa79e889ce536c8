"""Kernel rooflines: K1, K2, K3 and K7 against their bounds and their
structure probes P1-P4.

Counterpart of the JAX bench's ``kernel_rooflines`` (``bench.py:677``):
the same batch made from one snapshot with multiplicative noise, the same
inputs, and for each kernel its time, its work and bound, and its share
of the ceiling its own structure reaches (:mod:`..kernels.probes`):

- K1 (|grad q|^2) beside P4, a scaled copy on K1's blocks, and the library
  call ``torch.mul`` computing the same copy, on a stack of at least
  ``copy_bytes`` (256 MB: past the 50 MB L2);
- K2 (the two-channel CDF) beside P2, K2's first pass without its flushes;
- K3 (the linearized LWA, ``increase=True``) beside P1, K3's surface
  kernel without its E terms;
- K7 (lat-lon perimeters at N levels over the field's range) beside P3,
  K7 without its fixed-point totals.

The bound of a call is the larger of its bytes (each input read once, each
output written once) over the HBM rate and its FP32 instructions over the
instruction rate, the H100 SXM's published peaks at 700 W.  A probe does
its kernel's work (P4 its own bytes), so ``pct_of_structure_ceiling``, the
kernel's rate over the probe's in the unit that binds the kernel, is the
share of the time its structure needs.

    python -m xcontour_tpu_torch.utils.roofline

prints the result as one JSON line, on ``synth_pv`` at the JAX bench's
headline shape (32 x 256 x 512, N = 121) on the card.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

# the H100 SXM's published peaks at 700 W: HBM bytes/s, and FP32
# instructions/s (67 TFLOP/s with an FMA counted twice)
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 33.5e12
# K7's and K8's FP32 instructions: 6 to classify a cell (its corners' min
# and max), and for each crossed (cell, level) pair its segment as
# csrc/length.cu's crossing_length writes it: two edge points of 5 each (a
# difference, the zero test, a difference, the division, the scaling) and
# the segment, 22 on the sphere (two differences, two halvings, two sinf,
# two sums and two cosf, four products and a sum, the clamp's two, sqrtf,
# asinf, the doubling) or 3 in the plane (two differences, hypotf).  A
# math-library call or an IEEE division counts as one instruction and a
# saddle's second segment not at all, so the counts stay lower bounds.
CLASSIFY_INSTR = 6
SEGMENT_INSTR = {True: 32, False: 13}
# B's FP32 instructions: two compares a (box, level) test (the add of a
# crossed box's weight not counted)
BOX_TEST_INSTR = 2
# K1's and P4's stack on the card: at least this many bytes of snapshots
COPY_BYTES = 256e6
# each timing window: warm-up turns, then timed turns (the median is kept)
WARMUP, REPS = 3, 20
# cycles the card spins before a timing window, so the window's launches
# are all queued before it starts (~20 ms at 1.98 GHz)
_HOLD_CYCLES = 40_000_000


def lwa_work(B, Ny, Nx, pairs=None):
    """(bytes, FP32 instructions) of an LWA kernel: q, W, Q in, the field
    out; 3 instructions (sub, min/max, FMA) per (surface, cell) pair, every
    pair unless a part selection keeps fewer."""
    pairs = B * Ny * Ny * Nx if pairs is None else pairs
    return 4 * (2 * B * Ny * Nx + Ny * Nx + B * Ny), 3 * pairs


def stencil_work(B, Ny, Nx):
    """(bytes, FP32 instructions) of K1: q in, the field out, 1/dx and
    1/dy once; 6 instructions a cell (two differences, their scaling, the
    square sum)."""
    cells = B * Ny * Nx
    return 4 * (2 * cells + Ny * Nx + Ny), 6 * cells


def cdf_work(B, G, N, C, out=None):
    """(bytes, FP32 instructions) of K2: values, C weight channels and N+1
    edges in, the (B, C, N) CDF out (``out`` floats if given: P2 writes
    B); one add per (cell, channel)."""
    out = B * C * N if out is None else out
    return 4 * (B * G * (1 + C) + B * (N + 1) + out), B * C * G


def copy_work(B, Ny, Nx):
    """(bytes, FP32 instructions) of P4: q in, q * 1.0000001 out."""
    cells = B * Ny * Nx
    return 8 * cells, cells


def boxcount_work(B, Ny, W, N, strides, quirks=False):
    """(bytes, FP32 instructions) of B on B fields padded to (Ny, W): the
    field, the areas and the (B, N) levels in, the (B, N, S) totals out;
    BOX_TEST_INSTR a (box, level) test."""
    from ..kernels.boxcount import boxes
    nbox = sum(r * c for r, c in (boxes(Ny, W, s, quirks) for s in strides))
    return (4 * (B * Ny * W + Ny * W + B * N * (1 + len(strides))),
            BOX_TEST_INSTR * B * N * nbox)


def window_means_work(B, Ny, Nx, window, stride, itemsize=4):
    """(bytes, FP32 instructions) of R on B fields (Ny, Nx): the field read
    once and the (B, Wy, Wx) means written once, ``itemsize`` bytes a
    value; its adds are float64, so no FP32 instruction is counted."""
    from ..kernels.rolling import anchors
    Wy, Wx = anchors(Ny, window, stride), anchors(Nx, window, stride)
    return itemsize * B * (Ny * Nx + Wy * Wx), 0


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
    """Crossed (cell, level) pairs of data (B, Ny, Nx) at levels (B, N):
    each cell's count of sorted levels in its [lo, hi) by searchsorted."""
    lo, hi = corner_ranges(q)
    B = q.shape[0]
    srt = torch.sort(levels, dim=-1).values.contiguous()      # NaN last
    a = torch.searchsorted(srt, lo.reshape(B, -1).contiguous())
    e = torch.searchsorted(srt, hi.reshape(B, -1).contiguous())
    return int((e - a).clamp(min=0).sum())


def k7_work(q, levels, yc, xc, latlon, pairs=None, out=None):
    """(bytes, FP32 instructions) of K7: the field, levels and coordinates
    in, the (B, N) totals out (``out`` floats if given: P3 writes B);
    CLASSIFY_INSTR a cell and SEGMENT_INSTR a crossed pair (counted from
    the inputs unless given)."""
    if pairs is None:
        pairs = k7_crossed_pairs(q, levels)
    out = levels.numel() if out is None else out
    return (4 * (q.numel() + levels.numel() + out + yc.numel() + xc.numel()),
            CLASSIFY_INSTR * q.numel() + SEGMENT_INSTR[latlon] * pairs)


def time_alternating(fns, device, reps=REPS, warmup=WARMUP):
    """Median ms of each callable, the callables taking turns ``reps``
    times after ``warmup`` turns.  On the card (``device`` a CUDA device,
    on which the callables run): a pair of CUDA events
    around each call, all calls queued behind a spin kernel, so each time
    is the device's for back-to-back calls and no host time shows; on the
    CPU, the host clock."""
    for _ in range(warmup):
        for f in fns:
            f()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        ev = [[(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in fns]
              for _ in range(reps)]
        with torch.cuda.device(device):
            torch.cuda._sleep(_HOLD_CYCLES)
        for pairs in ev:
            for (start, stop), f in zip(pairs, fns):
                start.record()
                f()
                stop.record()
        torch.cuda.synchronize(device)
        times = [[pairs[i][0].elapsed_time(pairs[i][1]) for pairs in ev]
                 for i in range(len(fns))]
    else:
        times = [[] for _ in fns]
        for _ in range(reps):
            for t, f in zip(times, fns):
                t0 = time.perf_counter()
                f()
                t.append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(t) for t in times]


def _row(kernel, kwork, t_k, probe, pwork, t_p, cwork):
    """One kernel's entry: its time, work, bound and share, its probe's,
    and the kernel's rate over the probe's in the unit that binds the
    kernel, the probe's rate counted in ``cwork``: the kernel's work for a
    probe that does it (P1-P3), the probe's own for P4's copy."""
    b_ms, b_by = bound_ms(kwork)
    pb_ms, pb_by = bound_ms(pwork)
    unit = 0 if b_by == "bytes" else 1
    return dict(kernel=kernel.name, ms=t_k, bytes=kwork[0],
                instructions=kwork[1], bound_ms=b_ms, bound_by=b_by,
                pct_of_bound=100 * b_ms / t_k,
                probe=probe.name, probe_ms=t_p, probe_bytes=pwork[0],
                probe_instructions=pwork[1], probe_bound_ms=pb_ms,
                probe_bound_by=pb_by, probe_pct_of_bound=100 * pb_ms / t_p,
                pct_of_structure_ceiling=100 * (kwork[unit] / t_k)
                / (cwork[unit] / t_p))


def roofline_inputs(lat, lon, vor, batch=32, N=121, *, device=None):
    """The inputs :func:`kernel_rooflines` times its kernels and probes on
    (the same arguments; numpy seed 0): ``batch`` snapshots of ``vor``
    (Ny, Nx) each scaled by 1 + 1e-4 x a normal draw, as the JAX bench.
    A dict: 'q' (batch, Ny, Nx); 'qs', the batch repeated to a stack of at
    least COPY_BYTES on the card (past the L2; the batch alone on the
    CPU), with 'rdx' (Ny, Nx) and 'rdy' (Ny,) for K1 and P4; 'vals',
    'edges' (N + 1 over the batch's range) and 'wts' (two channels) for
    K2 and P2; 'Q' and 'W' for K3 and P1; 'levels' (N over the range),
    'yc' and 'xc' (radians) for K7 and P3."""
    from ..grid import _device

    dev = _device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    vor = np.asarray(vor, np.float64)
    Ny, Nx = vor.shape
    snaps = vor[None] * (1.0 + 1e-4 * rng.standard_normal((batch, 1, 1)))
    q = torch.as_tensor(snaps, **f32)
    nstack = batch if dev.type == "cpu" else \
        max(batch, math.ceil(COPY_BYTES / (4 * Ny * Nx)))
    lo, hi = float(np.nanmin(snaps)), float(np.nanmax(snaps))
    return dict(
        q=q, qs=q[torch.arange(nstack, device=dev) % batch].contiguous(),
        rdx=torch.as_tensor(rng.uniform(0.5, 1.0, (Ny, Nx)), **f32),
        rdy=torch.ones(Ny, **f32),
        Q=torch.as_tensor(np.sort(np.mean(snaps, -1), -1), **f32),
        W=torch.as_tensor(rng.uniform(0.5, 1.0, (Ny, Nx)), **f32),
        vals=q.reshape(batch, Ny * Nx),
        wts=torch.as_tensor(rng.uniform(0.5, 1.0, (batch, 2, Ny * Nx)),
                            **f32),
        edges=torch.as_tensor(
            np.linspace(lo, hi, N + 1)[None].repeat(batch, 0), **f32),
        levels=torch.as_tensor(
            np.linspace(lo, hi, N)[None].repeat(batch, 0), **f32),
        yc=torch.as_tensor(np.deg2rad(np.asarray(lat, np.float64)), **f32),
        xc=torch.as_tensor(np.deg2rad(np.asarray(lon, np.float64)), **f32))


def kernel_rooflines(lat, lon, vor, batch=32, N=121, *, device=None):
    """K1, K2, K3 and K7 beside their probes on :func:`roofline_inputs`
    (``batch`` snapshots of ``vor`` (Ny, Nx) on the grid ``lat`` (Ny,),
    ``lon`` (Nx,) in degrees).  ``device``: the card unless the CPU is
    asked for (the host clock then times the plain versions: no device
    figure).  Returns a dict: 'stencil', 'hist_cdf2', 'lwa' and 'length'
    entries (see :func:`_row`, with ``probe_plain_ms``, the probe's plain
    version's time, one call after one warm-up; 'stencil' with
    ``library_ms``, the time of ``torch.mul`` on P4's input), and the
    device, shape and levels of the run."""
    from ..kernels import hist, length, lwa, probes, stencil

    x = roofline_inputs(lat, lon, vor, batch, N, device=device)
    dev = x["q"].device
    q, qs, vals, edges, wts = x["q"], x["qs"], x["vals"], x["edges"], x["wts"]
    Q, W, levels, yc, xc = x["Q"], x["W"], x["levels"], x["yc"], x["xc"]
    nstack, Ny, Nx = qs.shape
    G = Ny * Nx
    pairs = k7_crossed_pairs(q, levels)

    def k1():
        return stencil.squared_gradient(qs, x["rdx"], x["rdy"],
                                        periodic_x=True)

    def mul():
        return torch.mul(qs, probes.SCALE)

    # key: (kernel, its call, its work, probe, its call, its plain version,
    # its work)
    cases = {
        "stencil": (stencil.KERNEL, k1, stencil_work(nstack, Ny, Nx),
                    probes.KERNEL_COPY, lambda: probes.scaled_copy(qs),
                    lambda: probes.scaled_copy_plain(qs),
                    copy_work(nstack, Ny, Nx)),
        "hist_cdf2": (hist.KERNEL, lambda: hist.weighted_cdf(vals, edges, wts),
                      cdf_work(batch, G, N, 2), probes.KERNEL_HIST,
                      lambda: probes.hist_structure(vals, edges, wts),
                      lambda: probes.hist_structure_plain(vals, edges, wts),
                      cdf_work(batch, G, N, 2, out=batch)),
        "lwa": (lwa.KERNEL_LIN, lambda: lwa.lwa_lin(q, Q, W, increase=True),
                lwa_work(batch, Ny, Nx), probes.KERNEL_LWA,
                lambda: probes.lwa_structure(q, Q, W),
                lambda: probes.lwa_structure_plain(q, Q, W),
                lwa_work(batch, Ny, Nx)),
        "length": (length.KERNEL_LENGTHS,
                   lambda: length.contour_lengths(q, levels, yc, xc,
                                                  latlon=True),
                   k7_work(q, levels, yc, xc, True, pairs),
                   probes.KERNEL_LENGTH,
                   lambda: probes.length_structure(q, levels, yc, xc),
                   lambda: probes.length_structure_plain(q, levels, yc, xc),
                   k7_work(q, levels, yc, xc, True, pairs, out=batch)),
    }
    out = dict(device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
               shape=[batch, Ny, Nx], N=N, copy_stack=nstack)
    for key, (kern, kfn, kwork, probe, pfn, pplain, pwork) in cases.items():
        fns = [kfn, pfn, mul] if key == "stencil" else [kfn, pfn]
        ts = time_alternating(fns, dev)
        out[key] = _row(kern, kwork, ts[0], probe, pwork, ts[1],
                        pwork if key == "stencil" else kwork)
        if key == "stencil":
            out[key]["library_ms"] = ts[2]
        out[key]["probe_plain_ms"] = time_alternating([pplain], dev, 1, 1)[0]
    return out


def nvidia_smi_line() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main():
    from .synth import synth_pv
    # one level of synth_pv is all NaN (its level ramp divides by zero)
    v, _ = synth_pv(nlev=2, nlat=256, nlon=512, seed=1)
    res = kernel_rooflines(v["latitude"], v["longitude"], v["pv"][0],
                           batch=32, N=121)
    res["card"] = nvidia_smi_line()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
