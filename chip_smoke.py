#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``xcontour_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``xcontour_tpu_torch/csrc`` and drives the
port's paths through the entry points a user calls: ``keff_lwa_pipeline``
(the combined step), ``lwa_pipeline`` and ``keff_pipeline``, at ERA5 scale
(721x1440 global isentropic PV, 15 levels per step, N=241, a seeded
below-ground NaN patch on the lowest levels), at the JAX bench's headline
shape (32x256x512), on the LAPE configuration (MITgcm x-z internal-wave
plane, 64 snapshots of 100x4480 per step) and on a tall 2x4096x512 grid;
and the geometry paths ``clength_pipeline`` (ERA5, N=121 and N=401),
``fractal_pipeline`` (headline shape, strides 1-32, box counting) and
``local_contour_lengths`` (ERA5 snapshots, window 101, stride 10).

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the kernels with nvcc (one process per source, in parallel);
  3. kernel checks: K1-K5 (K4 in both variants, and in split mode, both
     halves a launch) against their plain PyTorch
     versions on the same CUDA tensors at ERA5 and headline shapes; K2 also
     at the A(Y_eq) table build (1x(721*1440) row latitudes under a NaN
     mask, N = 721, one channel), clength_pipeline's five channels at
     N = 401, and uniform noise over the ERA5 step's edges; the
     kernels' other modes at the headline shape, and K6 (the dense kernel,
     both variants) at 2x4096x512, each within its stated bound; K3 and
     the 12 instances of K4 (3 parts x 2 directions x 2 variants) on the
     inputs that pin the XLA twin's behaviour (NaN and infinite weights,
     +-inf cells, a NaN profile row, a tie) at 2x40x128 and, as K6, at
     2x3104x128,
     with the plain version's NaN pattern; K1 at one column a lane (row
     lengths 182 and 361, and a view off 16-byte alignment), six modes bit
     for bit, and K2 with nine channels (two channel groups); K7
     (ERA5 lat-lon N=121 and N=401, headline Cartesian N=121) and K8 (the
     16 levels of an ERA5 step in one launch at window 101 / stride 10,
     as the path runs it) against their plain versions run in float64, beside
     the float32 plain versions' own errors, and two runs of each bit for
     bit; the exact-empty rule on the card (seed-7 tie fields, windows at
     their own minimum); the limits: K2, K3, K4 (both variants), K5 and
     K7 at a batch of 65,537 snapshots of 4x8, K8 with 65,599 window rows
     (the rows past 65,535 against the plain version on that part of the
     field), K2 at 16 channels x 4,000 bins and at 2 x 20,000 (bin
     ranges), K8 on an ERA5 level at windows 101 / stride 7 and 64 / 10
     (window - 1 not a multiple of the stride), 101 / 40 and 161 / 80
     (strides past 32 and 64) and 31 / 45 (a stride past the window), K7
     at 5,000 levels; K8 on the 16 levels of an ERA5 step in one launch
     against the 2-D K8 level by level, bit for bit, at 101 / 10 and those
     windows, and on 65,537 fields (past the 65,535 a launch takes); the archive decode D (``kernels.decode``) on raw
     planes of the benchmark archive's chunk (16x721x1440) in six layouts
     (big-endian float32 with the latitude flipped, masked, into float64,
     from big-endian float64, little-endian unflipped, Nx 1439) against its
     plain version on the card and the host path's chunk, bit for bit; box
     counting B (``kernels.boxcount``) at the t170.fractal step (the
     headline shape, N = 121, strides 1-32) against its plain version run
     in float64 and in float32, one launch a call, two runs bit for bit;
     K3 and K5 at the LAPE step (64x100x4480, increase=False, the
     profile of its lwa_pipeline) against their plain versions; G
     (``kernels.gradw``, clength_pipeline's five CDF weights) on the ERA5
     step and in six modes on K1's odd shapes (a flat patch where
     |grad q| = 0), bit for bit with its plain version; E
     (``kernels.extrema``, the contour levels) in both modes at the
     era5.*, t170.fractal and lape.lwa steps, bit for bit with the plain
     chain;
  4. the paths: for each, every launch count set to 0 just before it and
     read just after; a path fails if a kernel it runs was not launched.
     K2's counts must be exact: one launch per step and one per table
     build (an own-table keff_lwa step launches it twice); E's too: one
     call a step wherever levels are computed (the replayed graphs
     included), none in local_length_pipeline.
     keff_lwa_pipeline at ERA5 ('auto' and 'dense', 4 steps reusing one
     table plus one step that builds its own, and one own-table step
     alone) and at the headline shape;
     lwa_pipeline at ERA5 (metric='dy', 'auto' and 'dense', the same
     streaming; part='split', two K4 launches a step and no K3 or K5),
     part='upper' at the headline shape, the LAPE
     configuration (one K2, one K3 and one K5 launch a step with the
     table passed in) and the tall grid ('dense', K6); keff_pipeline at ERA5
     (hist=True, pre_y) and at the headline shape (hist=False);
     keff_lwa_pipeline(with_lwa2=True) once; clength_pipeline at ERA5
     (N=121 and N=401, the same streaming; one G launch a step),
     fractal_pipeline at the
     headline shape, local_length_pipeline on the ERA5 steps (one K8
     launch a step).  The outputs are checked (shapes, finite values,
     monotone areas, coordinates in range, LAPE positive-definite to the float32
     floor, empty extreme levels, positive interior lengths, the median
     fractal dimension in [1, 2)).  Then each benchmark step cell's entry
     at its shape (keff_lwa and clength at 16x721x1440, fractal at the
     headline shape, local_length at 16x721x1440, the LAPE lwa, the
     split lwa at 16x721x1440) through
     the pipeline's CUDA graphs: a warm-up call, a capture on another
     input and a replay on the first, each bit for bit with the eager
     body on the same input and counting its launches; keff_lwa and
     clength at 16x721x1440 timed by stage (tracing on): the timed
     replay bit for bit with the plain one, one stage record a call, the
     stages and the time outside them against a pair of events around
     the replay, the event nodes' device cost and a record's read on the
     host, and the stage split (``phase 4 timed graph json``);
  5. card against CPU: one small step of keff_lwa_pipeline, lwa_pipeline
     ('auto' and 'dense'), the LAPE configuration, keff_pipeline (hist
     True and False), clength_pipeline, fractal_pipeline and
     local_contour_lengths on the card against the same step on the CPU
     (plain versions), float32, stated tolerances;
  6. timing with CUDA events: for K1-K8 the kernel's and the plain
     version's ms, the bound (the larger of bytes over HBM rate and FP32
     instructions over instruction rate) and the share of it reached, and the
     launches per step of the kernel's path (K7's and K8's crossed pairs,
     counted from the inputs, in their bounds); K2 at its three other shapes;
     K4 part='upper' and part='split' at ERA5, and K4's split in turns
     with its upper and lower launches (LWA and LWA2; the halves bit for
     bit); K3 and K5 at the LAPE step, with their
     share of the bound and launches a step of its path; the
     device time of each CUDA kernel K3 and K5 launch (prep against
     surface kernel, torch.profiler) and the SM clock and power that
     nvidia-smi samples under K3 and K4; snapshots/s of each streamed step,
     peak device memory of each path; D in its six layouts in turns with
     its plain version and Tensor.copy_ of its output (device times); B at
     the t170.fractal step in turns with its plain version, against its
     bound (two FP32 compares a (box, level) test, or its bytes); R at the
     era5.local step and G at the ERA5 and era5.clength steps in turns
     with their plain versions, against their bytes bounds (G: 24 a
     cell); E at the era5.*, t170.fractal and lape.lwa steps in turns with
     the plain chain, against its bytes bound (the tracer read once);
  7. gradients: every kernel wrapper raises on a CUDA tensor that requires
     grad; each autograd Function (K1-K8) on the card: its forward against
     the wrapper's bits (K2 within its bound: float atomics) and its
     gradients of sum(r * out) against torch.autograd.grad through the
     plain version at 2x181x360 (K6 2x3104x128, K8 one level, window 31 /
     stride 10), then its forward and backward ms and the backward's peak
     memory at its path's shape (ERA5 B = 4, K6 the tall grid); the adjoint
     steps (the JAX bench's nansum(lwa^2) + nansum(nkeff) of
     keff_lwa_pipeline 'auto' at the headline shape and at ERA5 B = 4;
     'dense', with_lwa2, clength_pipeline and local_contour_lengths at ERA5
     B = 4), with forward and backward ms, gradient-snapshots/s, peak
     memory and launches a step (equal to a no-grad step's), the gradient
     nonzero and non-finite only within two cells of a NaN cell; each
     loss's gradient on the card against the port's CPU gradient at
     2x91x180.  The kernels JSON carries each Function's backward ms;
  8. the sort engines (plain PyTorch, no kernel of their own): the exact
     conditional integral against the broadcast one on the ERA5 step (lt
     and gt), cal_contours_at ('exact', 'broadcast', 'hist') at 241
     equivalent latitudes on the reused table, each timed with its peak
     memory, card against CPU at 2x256x512; lwa_pipeline(lwa_method=
     'fast') on the tall grid against 'dense' (K6) and
     keff_lwa_pipeline('fast', with_lwa2=True) at ERA5 against 'dense'
     (K4), with no LWA kernel launched on the 'fast' side, and NaN profile
     rows exactly zero; the lin/fast ladder (B = 4, Nx = 512, Ny from 1024
     to 8192, and the ERA5 step: K3, K5 and 'fast' for both variants) and
     the Ny from which 'fast' wins; 'auto' just below and at the port's
     crossover, by K3's and K5's launch counts;
  9. the facade, through the reference's names (``xcontour_tpu_torch.xcontour``)
     at ERA5 scale on a grid from ``add_latlon_metrics``: notebook 1's Keff
     chain on ``Contour2D`` (one A(Y_eq) table, then per step K1 once and K2
     once a channel) against ``keff_pipeline(hist=True)``; notebook 2's
     sorted profile and ``cal_local_wave_activity(mask_idx=[120, 360,
     600])``, ``cal_local_wave_activity2``, ``cal_local_APE`` and
     ``part='upper'`` against ``lwa_pipeline`` (K3, K5, K4 once each), the
     masks against the reference's rule and the rows rebuilt from them
     against K4; ``cal_contour_lengths`` (K7 once) against
     ``clength_pipeline``, and K7 against the host traversal
     (``find_contour`` + ``contour_length``, the native C++ library, which
     must load) on one level at two interior levels; ``cal_contours_at`` in
     its three forms against phase 8's levels; ``as_dataset`` of a B = 2
     ``keff_lwa_pipeline`` step and ``interp_to_dataset`` through nc3 and
     back, exact; ``add_MITgcm_missing_metrics`` and
     ``Contour2D.from_arrays`` on the LAPE section, ``cal_local_APE``
     against phase 4's LAPE ``lwa``; the card's facade at 2x91x180 against
     the float64 oracle ``compat``.  Each chain timed (CUDA events, median
     of 5) beside the pipeline it mirrors, with its launches a step and
     peak memory; the dataset path's host copies, nc3 write and read;
 10. the runner and the CLI (``python -m xcontour_tpu_torch``) on an
     ERA5-width archive: pv(time=6, level=15, 721, 1440) float32, latitude
     stored descending, written as nc3 into a temporary directory.
     ``keff-lwa -N 241 --batch 15`` in process with --stem and in memory
     (K1 once, K2 twice, K3 once, D and E once a chunk), each against
     keff_lwa_pipeline on the same snapshots by phase 9's comparator, the
     latitude ascending; end-to-end snapshots/s (host clock around
     cli.main, the open and the nc3 write included), the runner's rate a
     chunk, peak memory, the device's busy share from a utils.prof trace of
     the in-memory run; each stage alone a chunk (the host path's read and
     byte swap, the raw path's copy of the file's bytes and its decode, the
     decoded chunk the host path's bit for bit, the pinned copy, the
     host-to-device copy and its GB/s, the step, the
     fetch three ways, bit for bit alike, the .npz write) and the step's
     compute-only rate; the CLI as a subprocess killed with SIGKILL once
     two chunks exist and resumed in process (the survivors unchanged, the
     rest computed, the result as the uninterrupted run's); a fault healed
     by a retry, a skipped chunk's .failed record and NaN fill, a
     WireRangeError raised at once; the f16 and bf16 wires (the device
     input bit for bit the host rounding, outputs within the JAX suite's
     bounds); lwa ('auto' and 'dense'), keff, clength -N 401 and
     local-length on one time, fractal on the headline grid and lwa
     'dense' on the tall grid (K6), each with its exact launch counts (D
     once a chunk, none under --transfer or --mesh); clength_pipeline's G
     once a call, eager and replayed from its CUDA graph;
     --f64 on the card and nc4 without h5py refused with their messages,
     and info;
 11. the sharded path (``xcontour_tpu_torch.parallel``): (a) in this
     process an NCCL group of one (a FileStore in a temporary directory)
     and a ('cuda', (1, 1)) mesh at ERA5 width: each sharded function (the
     halo stencil on K1, the two-channel CDF on K2, the exact sort, LWA on
     K3, K4 and K5, the halo lengths on K7 at N = 121, the windowed
     lengths on K8) against its unsharded counterpart on the same card
     tensors, bit for bit or within KERNEL_BOUNDS; the sharded keff_lwa
     ('auto', 'dense'), lwa and clength (N = 121) steps and
     sharded_local_lengths with every launch count from 0 (E's extrema
     mode once a step, none in the windowed lengths), against the
     unsharded steps by phase 9's comparator; the sharded keff_lwa step
     timed against keff_lwa_pipeline (CUDA events, in turns); on phase
     10's archive ``keff-lwa --mesh 1`` and ``--mesh 1x1`` against the run
     without --mesh, and ``--mesh 2`` refused on one card; (b) which
     collectives gloo takes on CUDA tensors (two ranks each), then 2 gloo
     ranks (1x2) and 4 (2x2, 1x4) on the one card, each running the
     sharded keff_lwa step on its block of 30 ERA5 snapshots and the
     sharded lengths (K7, K8), joined and held against the unsharded step
     on the card, with each rank's launch counts (E twice: the step's
     levels and the lengths') and step time (not a scaling figure: the
     ranks share one card).
 12. the structure probes P1-P4 (``kernels.probes``, twins of K3, K2's
     first pass, K7 and K1 without their output machinery): each against
     its plain version on the same CUDA tensors at the ERA5 step (N = 241;
     P3 at the clength cells' N = 121 and 401) and at the headline shape
     (N = 121): P1 within K3's bound, P2 (also with values below the first
     edge, at and above the top one and a NaN weight) and P3 against the
     float64 plain version and two runs bit for bit, P4 bit for bit; then
     ``utils.roofline.kernel_rooflines`` through the port at ERA5 (batch
     15, N = 241) and at the headline (batch 32, N = 121), each a path with
     its launch counts: K1 beside P4 and ``torch.mul`` on a stack of at
     least 256 MB, K2 beside P2, K3 beside P1, K7 beside P3, one line a
     kernel with the card.  The kernels JSON gains P1-P4, and K1, K2, K3
     and K7 their share of their structure ceiling.

The last three lines are the kernels JSON, the card line from nvidia-smi,
and {"ok": true, "device": {...}}.  Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from xcontour_tpu_torch.utils.roofline import (
    CLASSIFY_INSTR, SEGMENT_INSTR, bound_ms, boxcount_work, cdf_work,
    corner_ranges,
    k7_crossed_pairs, k7_work, kernel_rooflines, lwa_work, nvidia_smi_line,
    stencil_work, time_alternating, window_means_work)

ERA5 = dict(B=15, nlat=721, nlon=1440, N=241)
HEADLINE = dict(B=32, nlat=256, nlon=512, N=121)
# Ny > 3072: the regime of the TPU's y-blocked kernel K6
TALL = dict(B=2, nlat=4096, nlon=512, N=241)
# the benchmark's mitgcm_xz_lape section (xcontour's Data/internalwave.nc
# at its 2 m columns), 64 snapshots a step
LAPE = dict(B=64, nz=100, nx=4480, N=121)
STREAM_STEPS = 4
# the geometry paths: the JAX bench's two contour counts (bench.py:1025),
# the fractal ladder of examples/ex4_contour_length.py, the reference's
# local-length window (tests/test_localLength.py)
CLENGTH_N = (121, 401)
FRACTAL_STRIDES = (1, 2, 4, 8, 16, 32)
LOCAL = dict(window=101, stride=10)
# the ERA5 levels of a step of the benchmark's local-length cell, which K8
# takes in one launch
LOCAL_B = 16
# the inputs of ROADMAP Queue 3 at test_torch_lwa.py's shape, and taller
# than 3072 rows for K6
QUEUE3_SHAPES = ((2, 40, 128), (2, 3104, 128))
# K2 beyond the ERA5 main step: the A(Y_eq) table build (one launch of
# 721x1440 row latitudes, N = 721 bins, one channel), clength_pipeline's
# five channels at its larger contour count, and uniform noise over the
# main step's edges (no runs of one bin to aggregate)
K2_SHAPES = ("table", "clength5", "noise")

# kernel vs plain version on the same CUDA tensors, relative to the plain
# output's largest magnitude
#   K1: the same float32 operations in the same order (no FMA): exact
#   K2: float32 sums in another order (register runs, shared-memory
#       atomics, per-block partials, a block scan)
#   K3: the 'lin' float32 floor (R and E cancel), the JAX suite's bound
#   K4 (both variants): the reference-order float32 bound of the JAX suite
#   K5: K3's bound: the same R and E cancellation (at ERA5 an H100
#       measured K5 3.6e-5 against K3's 5.5e-5; the port suite's tighter
#       LWA2 bound, 5e-5, is set on grids of at most 91 rows)
#   K6: K4's sums over 4096 rows, 5.7x ERA5's 721; a random walk at
#       2x4096x512 measured 2.3-3.9e-6 on an H100, so twice K4's bound
#   K7, K8: against the plain version run in float64 on the same card
#       inputs (so a kernel more exact than its float32 plain form is not
#       taken for a wrong one): float32 sums of ~10^5 segment lengths, each
#       within a few ulps; at ERA5 an H100 measured 1.5e-7 (K7) and 1.3e-7
#       (K8), the float32 plain versions 1.1e-7 and 6.0e-7
#   P1: K3's bound against its float32 plain version (the same sums of
#       721 rows a surface, without K3's cancellation); at ERA5 an H100
#       measured 2.3e-6
#   P2, P3: against the plain version run in float64, as K7's: float32
#       sums of ~10^6 cells (P2) or ~10^7 segment lengths (P3) in another
#       order, in registers, then in fixed-order folds; at ERA5 an H100
#       measured 5.9e-8 (P2) and 1.1e-7 (P3, N = 121 and 401); P3 takes
#       K7's bound
#   P4: bit for bit (one float32 product a cell)
#   B: against the plain version run in float64 (BOX_BOUND): the same
#       crossed (box, level) pairs, float32 sums of up to ~10^5 positive
#       weights in another order; at the t170.fractal step an H100
#       measured 3.2e-7, the float32 plain version 3.2e-7
BOX_BOUND = 2e-6
KERNEL_BOUNDS = dict(squared_gradient=1e-6, weighted_cdf=1e-5,
                     lwa_lin=1.5e-4, lwa_dense=5e-6, lwa_dense_v2=5e-6,
                     lwa_dense_upper=5e-6, lwa_dense_split=5e-6,
                     lwa_lin2=1.5e-4, lwa_dense_tall=1e-5,
                     lwa_dense_tall_v2=1e-5, contour_lengths=2e-6,
                     local_lengths=2e-6, lwa_structure_probe=1.5e-4,
                     hist_structure_probe=1e-6, length_structure_probe=2e-6,
                     copy_probe=0.0, box_counts=BOX_BOUND)
# card (kernels) against CPU (plain versions), float32, relative to each
# output's largest magnitude: summation order for the sorted state (2e-5);
# Yeq and Lmin come from a table lookup of float32 areas, where near the
# poles dYeq/dA is steep (1e-4); Leq2 differences CDFs along the contour
# index (1e-4); lwa at the 'lin' floor; nkeff = Leq2 / Lmin^2 with
# Lmin ~ cos(Yeq): near the poles a Yeq difference of d radians moves it by
# 2 tan(Yeq) d, ~1e3 times the area noise, and a value at its threshold
# may be NaN on one side only; latEq is Yeq under lwa_pipeline's name;
# dgrdSdA and dqdA difference CDFs like Leq2; lwa2 at lwa's bound; the
# contour means cmGrd and cmInvGrd difference CDFs like Leq2; the levels of
# cal_contours_at come through a table lookup like Yeq; rulers scale
# with cos(Yeq); D and D_bc are log-log slopes over three lengths, where the
# shortest contours' relative error counts in full (the CPU suite measured
# 9e-5 between the port and the JAX package).  local_contour_lengths runs
# at the CPU's window means on both sides (a window's length can jump with
# its level near a saddle), and the window means are compared on their own.
# An interpolated key (``*_at``) takes its source key's tolerance.
CARD_CPU_TOL = dict(Yeq=1e-4, latEq=1e-4, Lmin=1e-4, Leq2=1e-4, nkeff=2e-3,
                    lwa=1.5e-4, lwa2=1.5e-4, dgrdSdA=1e-4, dqdA=1e-4,
                    cmGrd=1e-4, cmInvGrd=1e-4, rulers=1e-4, D=5e-4,
                    D_bc=5e-4, levels=1e-4)
CARD_CPU_TOL_DEFAULT = 2e-5
NKEFF_MASK = 2e7

# the bound of a kernel (xcontour_tpu_torch.utils.roofline.bound_ms): the
# larger of its bytes (each input read once, each output written once) over
# the HBM rate and its FP32 instructions over the instruction rate, the H100
# SXM's published peaks at 700 W; the work models of K1, K2, K3-K6 and K7
# live there too.  K8 classifies each field cell that a window covers once
# (CLASSIFY_INSTR), and tests each (window, lattice block it covers) pair
# with two compares (its level against the block's [min, max)): the least
# work of a pretested design.
PRETEST_INSTR = 2
# K8's windows beyond the path's 101 / 10 (phase 3 against the float64
# plain version, phase 6 timed): window - 1 not a multiple of the stride
# (101 / 7, 64 / 10), strides past a warp's 32 lanes a row (101 / 40:
# several column steps a block) and past the 64 staged coordinates
# (161 / 80), and a stride past the window (31 / 45)
K8_WINDOWS = ((101, 7), (64, 10), (101, 40), (161, 80), (31, 45))
# the limits of phase 3: a batch past CUDA's 65,535 grid y and z, and K8's
# window rows past it (window 2, stride 1 on LIMIT_ROWS x 8)
LIMIT_B = 65537
LIMIT_ROWS = 65600
# phase 7, the autograd Functions: each against torch.autograd.grad through
# its plain version on the same card inputs at GRAD_CHECK (K6 at GRAD_TALL,
# K8 on one level at GRAD_LOCAL), within GRAD_BOUND of the largest
# |gradient| (the backward recomputes the same plain version, chunk by
# chunk: only the order of the sums differs); the adjoint steps at ERA5
# with GRAD_ERA5_B snapshots (the JAX bench's ERA5 adjoint batch,
# bench.py:335) and at HEADLINE; card against CPU at GRAD_SMALL, where
# GRAD_CARD_CPU[1] of the cells must lie within GRAD_CARD_CPU[0] of the
# largest |gradient| (the forward's float32 noise, the 'lin' floor among it,
# reaches the gradient through the loss)
GRAD_CHECK = dict(B=2, nlat=181, nlon=360, N=61)
GRAD_TALL = (2, 3104, 128)
GRAD_LOCAL = dict(window=31, stride=10)
GRAD_ERA5_B = 4
GRAD_SMALL = dict(B=2, nlat=91, nlon=180, N=121)
GRAD_BOUND = 1e-5
GRAD_CARD_CPU = (1e-3, 0.999)
# phase 8, the sort engines (plain PyTorch: sort, cumsum, searchsorted,
# gather).  The exact conditional integral against the broadcast one on the
# same card tensors, within EXACT_BOUND of the largest sum: float32 sums of
# the same weights in another order (sorted prefix sums against chunked
# tree sums; K2's bound).  cal_contours_at at EXACT_PREDEF equivalent
# latitudes on the reused table; its 'exact' and 'broadcast' levels within
# LEVELS_BOUND of the largest level (the table lookup's bound, Yeq's in
# CARD_CPU_TOL).  'fast' LWA and LWA2 against 'dense' (K4, K6) within
# FAST_BOUND of the field maximum: the JAX suite's float32 floor for 'fast'
# (tests/test_lwa_fast.py).  The lin/fast ladder: LADDER_B snapshots of
# Ny x LADDER_NX at LADDER_NYS (the shape and rows of the JAX package's
# crossover ladder, diagnostics/lwa.py, and 5120 between its 4096 and
# 6144) and the ERA5 step, median of LADDER_REPS calls after a warm-up.
EXACT_PREDEF = (-89.0, 89.0, 241)
EXACT_BOUND = 1e-5
LEVELS_BOUND = 1e-4
FAST_BOUND = 1e-4
LADDER_B, LADDER_NX = 4, 512
LADDER_NYS = (1024, 2048, 3072, 4096, 5120, 6144, 8192)
LADDER_REPS = 5
# phase 9, the facade: Contour2D and the reference namespace driven as the
# reference's notebooks drive them, against the pipelines they mirror on the
# same CUDA tensors.  K2's float atomics sum in another order each launch
# (two runs of one pipeline differ), and the facade launches K2 once a
# channel where the pipelines launch it once for two.  So an output is held
# within FACADE_BOUND of its largest magnitude where only that order
# differs; the keys a table lookup or a difference along the contour index
# amplifies take their CARD_CPU_TOL bounds, on the contours that enclose,
# and leave out, EXTREME_AREA of the largest enclosed area or more (the
# contour levels and the integrals on every contour).  Towards a pole the
# area left out is a ~ pi R^2 cos^2(Yeq), so Lmin ~ sqrt(a) and
# nkeff ~ 1/a, and K2's float order, ~2e-7 of the total area on an H100,
# moves nkeff by 2e-7 / EXTREME_AREA = 2e-3 (CARD_CPU_TOL's nkeff) of itself
# at a = EXTREME_AREA.  On the extreme contours (a few a level: the ERA5
# polar cell is 4e5 m^2, the order's noise ~1e8) the order alone decides
# Yeq, Lmin, the differences of areas and nkeff, which differed by 59% of
# the largest nkeff there on an NVIDIA H100 80GB HBM3 at 700 W.  nkeff
# through threshold_agree.  LWA, LWA2, APE and part='upper' within
# FACADE_BOUND of local_wave_activity[2] on the facade's own Q, and within
# CARD_CPU_TOL['lwa'] of the pipeline's, whose Q differs by K2's order (4e-6
# of the max on an H100, which the 'lin' cancellation took to 4.8e-5 of the
# field maximum).  MASK_IDX: the
# surfaces of the reference's LWA notebook (rows 120, 360, 600 of 721:
# 60S, the equator, 60N).  K7 against the host traversal within the float64
# bound of phase 3 (KERNEL_BOUNDS['contour_lengths']).  FACADE_SMALL: the
# card's facade against the float64 oracle (compat), at CARD_CPU_TOL.
# DATASET_B: the labelled dataset's batch (a step's outputs written to nc3).
FACADE_BOUND = 1e-5
EXTREME_AREA = 1e-4
MASK_IDX = (120, 360, 600)
FACADE_SMALL = dict(B=2, nlat=91, nlon=180, N=121)
DATASET_B = 2
# phase 10, an archive through the runner and the CLI: ARCHIVE is an
# ERA5-width pv(time, level, latitude, longitude), float32, each time a
# make_pv of its own seed (phase 4's below-ground NaN patch), latitude
# stored descending as ERA5 stores it, written as nc3 into a temporary
# directory; keff-lwa at N = 241 in chunks of one time's 15 levels, with
# --stem and in memory, held to keff_lwa_pipeline on the same snapshots on
# the card by phase 9's comparator and bounds (facade_vs; K2's float
# atomics differ between runs, so nothing is bit for bit).  The temporary
# disk must hold CLI_DISK_FACTOR archives at once (the archive, a stem's
# chunks and an output), else `time` is cut, never the grid.  WIRE_BOUND:
# the JAX suite's bounds on a step's outputs through each wire, 2e-3 for
# f16 and 2e-2 for bf16 at unit scale (tests/test_runner_checks.py
# test_transfer_dtype_f16_bounded_error and test_transfer_dtype_bf16),
# here relative to the chunk's largest magnitude.
ARCHIVE = dict(time=6, level=15, nlat=721, nlon=1440, N=241, seed=300)
CLI_DISK_FACTOR = 4
WIRE_BOUND = dict(f16=2e-3, bf16=2e-2)
# phases 3 and 6, the archive decode D (kernels.decode): raw planes of the
# benchmark archive's chunk (one time of era5_pv16: 16 levels at ERA5
# width, make_pv's field) in the layouts the CLI meets.  DECODE_CASES:
# name, file dtype, run dtype, latitude stored descending, a fluid mask,
# Nx (1439: one cell a lane).  The kernel against its plain version on the
# same card tensors and against the host path's chunk (_LazyField's
# field[rows]): NaN at the same cells, every other cell bit for bit.  The
# bound: each cell's file bytes in and its value out once, the mask's
# plane once.
DECODE = dict(B=16, nlat=721, nlon=1440, seed=500)
DECODE_CASES = (
    ("be_f4_desc", ">f4", np.float32, True, False, 1440),     # the archive
    ("be_f4_desc_mask", ">f4", np.float32, True, True, 1440),
    ("be_f4_desc_f64", ">f4", np.float64, True, False, 1440),  # --f64
    ("be_f8_desc", ">f8", np.float32, True, False, 1440),
    ("le_f4_asc", "<f4", np.float32, False, False, 1440),
    ("be_f4_desc_nx1439", ">f4", np.float32, True, False, 1439),
)
# phase 11, the sharded path (xcontour_tpu_torch.parallel): (a) in this
# process, an NCCL group of one on a ('cuda', (1, 1)) mesh at ERA5 width,
# each sharded function against its unsharded counterpart (bit for bit,
# else within the kernel's KERNEL_BOUNDS) and each sharded step by phase
# 9's comparator, the sharded keff_lwa step timed against
# keff_lwa_pipeline in turns, PAR_REPS each; (b) PAR_MESHES of gloo ranks
# whose tensors live on the one card (NCCL refuses two ranks on one GPU),
# PAR_B ERA5 snapshots (two steps), and which collectives gloo takes on
# CUDA tensors (PAR_COLLECTIVES, 2 ranks each).  A rank that fails, or a
# wait past PAR_TIMEOUT_S, fails the phase.
PAR_REPS = 9
PAR_B = 30
PAR_MESHES = ("1x2", "2x2", "1x4")
PAR_COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor",
                   "all_gather", "gather", "reduce_scatter_tensor",
                   "send_recv", "batch_isend_irecv")
PAR_TIMEOUT_S = 300
PAR_Q_BOUND = CARD_CPU_TOL["Yeq"]
# phase 11's gradients: the sharded keff_lwa 'auto' and clength adjoints
# (phase 7's losses, a replicated output counted once per mesh) at ERA5
# with GRAD_ERA5_B snapshots, on the mesh of one against phase 7's
# unsharded adjoints, forward and backward timed in turns PAR_GRAD_REPS
# times each after a warm-up; then the keff_lwa adjoint and the windowed
# lengths' (LOCAL on the headline's first snapshot) on PAR_GRAD_MESHES of
# gloo ranks, joined.  Every gradient is held to the unsharded card
# gradient on the same inputs by phase 7's card-against-CPU bound
# (GRAD_CARD_CPU): K2's float atomics add in another order each launch,
# and the x ranks' partial sums in another order again.
PAR_GRAD_REPS = 5
PAR_GRAD_MESHES = ("1x2", "2x2")
# phase 12, the structure probes P1-P4: the roofline keys of
# utils.roofline.kernel_rooflines, each with its kernel and its probe
ROOFLINE_KEYS = ("stencil", "hist_cdf2", "lwa", "length")

# no single PyTorch call computes any of K1-K8 (torch.histogram has no CUDA
# form, torch.histc takes no weights, torch.bincount weighs integer bins
# that a torch.bucketize must find first and leaves the cumsum; no call
# computes LWA, |grad q|^2 with metric factors or contour lengths), so
# every library_ms of K1-K8 is null (P4's is torch.mul's)
LIBRARY_MS = None


def log(*args):
    print(*args, flush=True)


def make_pv(B, nlat, nlon, seed):
    """Synthetic isentropic PV (B levels) with a seeded below-ground NaN
    patch on the three lowest levels, over a plateau-sized box."""
    from xcontour_tpu_torch.utils.synth import synth_pv
    v, _ = synth_pv(nlev=B, nlat=nlat, nlon=nlon, seed=seed)
    pv = v["pv"]
    rng = np.random.default_rng(seed)
    lat, lon = v["latitude"], v["longitude"]
    for lev in range(min(3, B)):
        lat0 = rng.uniform(25.0, 35.0)
        lon0 = rng.uniform(70.0, 90.0)
        box = ((lat >= lat0) & (lat <= lat0 + 8.0 - 2.0 * lev))[:, None] & \
              ((lon >= lon0) & (lon <= lon0 + 25.0 - 5.0 * lev))[None, :]
        pv[lev][box] = np.nan
    return v["latitude"], v["longitude"], pv


def rel_err(got, want):
    """(max abs difference over cells finite in both, that over the plain
    output's largest magnitude); raises if the NaN patterns differ."""
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError("NaN patterns differ")
    m = torch.isfinite(got) & torch.isfinite(want)
    if not torch.equal(m, torch.isfinite(want)):
        raise AssertionError("finite patterns differ")
    if not m.any():
        return 0.0, 0.0
    err = (got[m].double() - want[m].double()).abs().max().item()
    scale = want[m].double().abs().max().item()
    return err, err / scale if scale > 0 else err


def threshold_agree(got, want, tol, mask=NKEFF_MASK):
    """nkeff is NaN at and above its threshold ``mask``: a cell NaN on one
    side only is accepted when the other side lies within ``tol`` of the
    threshold, and then set NaN on both sides."""
    one = torch.isnan(got) ^ torch.isnan(want)
    other = torch.where(torch.isnan(got), want, got)[one]
    if bool((other < mask * (1 - tol)).any()):
        raise AssertionError("nkeff NaN where the other side is below the "
                             "threshold")
    nan = torch.full_like(got, float("nan"))
    return torch.where(one, nan, got), torch.where(one, nan, want)


def cuda_ms(fn, reps):
    """Mean milliseconds per call, by CUDA events around ``reps`` calls
    after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_split(fn, calls=10):
    """{kernel: device ms per call} of the CUDA kernels ``fn`` launches, by
    torch.profiler over ``calls`` calls after a warm-up; the port's LWA,
    CDF and length kernels by name, torch's own summed as 'torch'.  The
    port's spans (``utils.prof``) are ranges, not kernels: their device
    rows (each the span's whole extent on the card) are left out."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0) or 0
        if t > 0 and not evt.key.startswith(("aten::", "pipeline.",
                                             "stage.")):
            m = re.search(r"(?:lwa_\w+|cdf_\w+|local_lengths|lengths"
                          r"|spacing_scale|fixed_to_float)_kernel", evt.key)
            name = m.group(0) if m else "torch"
            split[name] = split.get(name, 0.0) + t / calls / 1e3
    if not split:
        raise RuntimeError("torch.profiler recorded no device time")
    return split


def clock_under_load(fn, seconds=2.0):
    """(median SM MHz, median W, samples, ms per call) that nvidia-smi
    samples every 100 ms while ``fn`` runs back to back."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        fn()
        torch.cuda.synchronize()
        calls, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            calls += 10
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / calls
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    samples = []
    for line in out.splitlines():
        try:
            samples.append([float(v) for v in line.split(",")[:2]])
        except ValueError:
            continue
    if not samples:
        raise RuntimeError("nvidia-smi gave no clock samples")
    mhz, watts = zip(*samples)
    return (statistics.median(mhz), statistics.median(watts), len(samples),
            ms)


def kernel_cases(q, grid, N):
    """name -> (kernel call, plain call, (bytes, instructions)) for K1-K5
    (K4 in both variants, part='upper' and part='split'), at the shapes the main path
    gives them: the inputs are what keff_lwa_pipeline computes on the
    way (work: utils.roofline's stencil_work, cdf_work, lwa_work)."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.diagnostics.lwa import nanmax
    from xcontour_tpu_torch.kernels import hist, lwa, stencil
    from xcontour_tpu_torch.ops import histogram, stencil as ops_stencil

    B, Ny, Nx = q.shape
    dy, dx = ops_stencil._spacing(grid, q.dtype)
    rdx, rdy = (1.0 / dx).contiguous(), (1.0 / dy).contiguous()
    grdS = stencil.squared_gradient_plain(q, rdx, rdy, periodic_x=grid.periodic_x)
    dA = grid.dA
    ctr = xt.cal_contours(q, N)
    _, edges = histogram._edges(ctr)
    vf = q.reshape(B, -1).contiguous()
    wf = torch.stack([torch.broadcast_to(dA, q.shape).reshape(B, -1),
                      (grdS * dA).reshape(B, -1)], 1).contiguous()
    Q = xt.keff_lwa_pipeline(q, grid, N=N)["Q"].contiguous()
    W = (dA / nanmax(dA) * dA).contiguous()
    lwa_all = lwa_work(B, Ny, Nx)
    return {
        "squared_gradient": (
            lambda: stencil.squared_gradient(q, rdx, rdy,
                                             periodic_x=grid.periodic_x),
            lambda: stencil.squared_gradient_plain(
                q, rdx, rdy, periodic_x=grid.periodic_x),
            stencil_work(B, Ny, Nx)),
        "weighted_cdf": (
            lambda: hist.weighted_cdf(vf, edges.contiguous(), wf),
            lambda: hist.weighted_cdf_plain(vf, edges, wf),
            cdf_work(B, Ny * Nx, edges.shape[-1] - 1, wf.shape[1])),
        "lwa_lin": (
            lambda: lwa.lwa_lin(q, Q, W, increase=True),
            lambda: lwa.lwa_lin_plain(q, Q, W, increase=True), lwa_all),
        "lwa_dense": (
            lambda: lwa.lwa_dense(q, Q, W, increase=True),
            lambda: lwa.lwa_dense_plain(q, Q, W, increase=True), lwa_all),
        # an increasing tracer's upper part keeps the pairs with y >= j
        "lwa_dense_upper": (
            lambda: lwa.lwa_dense(q, Q, W, increase=True, part="upper"),
            lambda: lwa.lwa_dense_plain(q, Q, W, increase=True,
                                        part="upper"),
            lwa_work(B, Ny, Nx, B * Nx * Ny * (Ny + 1) // 2)),
        # both halves stacked, from one pass over every pair
        "lwa_dense_split": (
            lambda: lwa.lwa_dense(q, Q, W, increase=True, part="split"),
            lambda: lwa.lwa_dense_plain(q, Q, W, increase=True,
                                        part="split"), lwa_all),
        "lwa_lin2": (
            lambda: lwa.lwa_lin2(q, Q, W, increase=True),
            lambda: lwa.lwa_lin2_plain(q, Q, W, increase=True), lwa_all),
        "lwa_dense_v2": (
            lambda: lwa.lwa_dense(q, Q, W, increase=True, variant2=True),
            lambda: lwa.lwa_dense_plain(q, Q, W, increase=True,
                                        variant2=True), lwa_all),
    }


def k2_cases(q, grid, N):
    """name -> (kernel call, plain call, (bytes, instructions)) for K2 at
    the shapes of K2_SHAPES, made from the ERA5 step q: the table build
    (row latitudes under the NaN mask of q's lowest level, N = Ny bins,
    dA), clength_pipeline's five weights at CLENGTH_N[1] levels, and
    values drawn uniformly (numpy seed 0) between the edges of the main
    step's N levels, with its two weights."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.kernels import hist, stencil
    from xcontour_tpu_torch.ops import histogram, stencil as ops_stencil

    B, Ny, Nx = q.shape
    G = Ny * Nx
    dA = grid.dA
    dy, dx = ops_stencil._spacing(grid, q.dtype)
    grdS = stencil.squared_gradient_plain(q, (1.0 / dx).contiguous(),
                                          (1.0 / dy).contiguous(),
                                          periodic_x=grid.periodic_x)
    grdm = torch.sqrt(grdS)
    mask = torch.isfinite(q[0])
    lat = torch.broadcast_to(grid.ydef[:, None], (Ny, Nx))
    vt = torch.where(mask, lat, torch.full_like(lat, float("nan")))
    _, et = histogram._edges(grid.ydef[None])
    ins = {"table": (vt.reshape(1, G), et, dA.reshape(1, 1, G))}
    _, e5 = histogram._edges(xt.cal_contours(q, CLENGTH_N[1]))
    w5 = [dA, grdS * dA, (grdm * grdm) * dA, grdm * dA,
          ((1.0 / grdm) * grdm) * dA]
    ins["clength5"] = (q.reshape(B, G), e5, torch.stack(
        [torch.broadcast_to(w, q.shape).reshape(B, G) for w in w5], 1))
    _, en = histogram._edges(xt.cal_contours(q, N))
    u = torch.as_tensor(np.random.default_rng(0).uniform(size=(B, G)),
                        dtype=q.dtype, device=q.device)
    vn = en[:, :1] + (en[:, -1:] - en[:, :1]) * u
    ins["noise"] = (vn, en, torch.stack([torch.broadcast_to(dA, q.shape),
                                         grdS * dA], 1).reshape(B, 2, G))
    cases = {}
    for tag in K2_SHAPES:
        v, e, w = (t.contiguous() for t in ins[tag])
        work = cdf_work(*v.shape, e.shape[-1] - 1, w.shape[1])
        cases[f"weighted_cdf_{tag}"] = (
            lambda v=v, e=e, w=w: hist.weighted_cdf(v, e, w),
            lambda v=v, e=e, w=w: hist.weighted_cdf_plain(v, e, w), work)
    return cases


def clength_weights_case(q, grid):
    """(kernel call, plain call, (bytes, instructions)) of G on the step q
    as clength_pipeline hands it over: the grid's dx, dy and dA.  Bytes: q
    read and five channels written once, 24 a cell, and dx, dy and dA
    once (the batch shares them)."""
    from xcontour_tpu_torch.kernels import gradw
    from xcontour_tpu_torch.ops import stencil as ops_stencil
    dy, dx = ops_stencil._spacing(grid, q.dtype)
    args = (q, dx.contiguous(), dy.contiguous(),
            grid.dA.to(q.dtype).contiguous())
    kw = dict(periodic_x=grid.periodic_x, bc_y=grid.bc_y)
    B, Ny, Nx = q.shape
    nbytes = q.element_size() * (B * Ny * Nx * (1 + gradw.CHANNELS)
                                 + 2 * Ny * Nx + Ny)
    return (lambda: gradw.clength_weights(*args, **kw),
            lambda: gradw.clength_weights_plain(*args, **kw), (nbytes, 0))


def clength_weights_checks(q, grid, errs):
    """Phase 3: G on the ERA5 step (its below-ground NaN boxes) against its
    plain version on the same card tensors, bit for bit, one launch."""
    from xcontour_tpu_torch.kernels import gradw
    kern, plain, _ = clength_weights_case(q, grid)
    n0 = gradw.KERNEL.launches
    got = kern()
    torch.cuda.synchronize()
    _expect(gradw.KERNEL.launches == n0 + 1,
            f"clength_weights: {gradw.KERNEL.launches - n0} launches, not 1")
    want = plain()
    _expect(same_bits(got, want), f"clength_weights era5 "
            f"{tuple(got.shape)}: differs from its plain version")
    errs["clength_weights_era5"] = 0.0
    log(f"phase 3 kernel clength_weights era5 {tuple(got.shape)}: bit for "
        f"bit with its plain version OK ({int(torch.isnan(q).sum())} NaN "
        f"cells of q, {int(torch.isnan(got[:, 4]).sum())} NaN cells in "
        "channel 4)")


def contour_levels_cases(era_q, head_q, lape_q):
    """(label, tracer, N, increase) of E at the steps of the cells that
    compute levels: the era5.* step (16x721x1440, era5.clength's N), the
    t170.fractal step and the lape.lwa step (decreasing levels, rock as
    NaN)."""
    return (("era5", era_q, CLENGTH_N[1], True),
            ("t170.fractal", head_q, HEADLINE["N"], True),
            ("lape.lwa", lape_q, LAPE["N"], False))


def contour_levels_checks(cases, errs):
    """Phase 3: E's levels and its extrema mode against the plain chain on
    the same card tensors, bit for bit, one launch a call."""
    from xcontour_tpu_torch.kernels import extrema
    for label, q, N, increase in cases:
        n0 = extrema.KERNEL.launches
        got = extrema.contour_levels(q, N, increase=increase)
        lo, hi = extrema.masked_extrema(q)
        torch.cuda.synchronize()
        _expect(extrema.KERNEL.launches == n0 + 2, f"contour_levels "
                f"{label}: {extrema.KERNEL.launches - n0} launches, not 2")
        want = extrema.contour_levels_plain(q, N, increase=increase)
        wlo, whi = extrema.masked_extrema_plain(q)
        _expect(same_bits(got, want) and same_bits(lo, wlo)
                and same_bits(hi, whi), f"contour_levels {label} "
                f"{tuple(q.shape)}: differs from the plain chain")
        errs[f"contour_levels_{label}"] = 0.0
        log(f"phase 3 kernel contour_levels {label} {tuple(q.shape)} N={N} "
            f"increase={increase}: levels and extrema bit for bit with the "
            f"plain chain OK ({int(torch.isnan(q).sum())} NaN cells)")


def tall_cases(q, grid, N):
    """K6: the dense kernel in both variants at a grid taller than 3072
    rows, with the sorted profile of the grid's own lwa_pipeline."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.diagnostics.lwa import nanmax
    from xcontour_tpu_torch.kernels import lwa
    Q = xt.lwa_pipeline(q, grid, N=N)["Q"].contiguous()
    W = (grid.dA / nanmax(grid.dA) * grid.dA).contiguous()
    work = lwa_work(*q.shape)
    return {
        "lwa_dense_tall": (
            lambda: lwa.lwa_dense(q, Q, W, increase=True),
            lambda: lwa.lwa_dense_plain(q, Q, W, increase=True), work),
        "lwa_dense_tall_v2": (
            lambda: lwa.lwa_dense(q, Q, W, increase=True, variant2=True),
            lambda: lwa.lwa_dense_plain(q, Q, W, increase=True,
                                        variant2=True), work),
    }


def lape_cases(q, grid, mask, N):
    """K3 and K5 at the LAPE step, as lwa_pipeline runs them there: a
    tracer decreasing down the rows (increase=False), partial cells and
    rock, the profile of the step's own lwa_pipeline."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.diagnostics.lwa import nanmax
    from xcontour_tpu_torch.kernels import lwa
    Q = xt.lwa_pipeline(q, grid, mask, N=N, increase=False,
                        lt=False)["Q"].contiguous()
    W = (grid.dA / nanmax(grid.dA) * grid.dA).contiguous()
    work = lwa_work(*q.shape)
    return {name: (lambda k=k: k(q, Q, W, increase=False),
                   lambda p=p: p(q, Q, W, increase=False), work)
            for name, k, p in (("lwa_lin", lwa.lwa_lin, lwa.lwa_lin_plain),
                               ("lwa_lin2", lwa.lwa_lin2,
                                lwa.lwa_lin2_plain))}


def variant_cases(q, grid):
    """(name, kernel call, plain call, bound) for the modes the main paths
    do not run: non-periodic x, 'fill' and 'reflect' walls, a decreasing
    tracer, and the upper/lower part selections of both LWA variants."""
    from xcontour_tpu_torch.kernels import lwa, stencil
    from xcontour_tpu_torch.ops import stencil as ops_stencil
    dy, dx = ops_stencil._spacing(grid, q.dtype)
    rdx, rdy = (1.0 / dx).contiguous(), (1.0 / dy).contiguous()
    cases = []
    for periodic in (True, False):
        for bc in ("extend", "fill", "reflect"):
            kw = dict(periodic_x=periodic, bc_y=bc)
            cases.append((f"squared_gradient periodic={periodic} {bc}",
                          lambda kw=kw: stencil.squared_gradient(q, rdx, rdy, **kw),
                          lambda kw=kw: stencil.squared_gradient_plain(q, rdx, rdy, **kw),
                          KERNEL_BOUNDS["squared_gradient"]))
    B, Ny, _ = q.shape
    qd = -q                                     # a decreasing tracer
    lo = torch.nan_to_num(q, nan=float("inf")).amin((-2, -1))
    hi = torch.nan_to_num(q, nan=float("-inf")).amax((-2, -1))
    ramp = torch.linspace(0.0, 1.0, Ny, device=q.device)
    Q = (lo[:, None] + (hi - lo)[:, None] * ramp[None]).contiguous()
    Qd = (-Q).contiguous()
    W = (grid.dA / grid.dA.amax() * grid.dA).contiguous()
    for name, kern, plain in (("lwa_lin", lwa.lwa_lin, lwa.lwa_lin_plain),
                              ("lwa_lin2", lwa.lwa_lin2, lwa.lwa_lin2_plain)):
        cases.append((f"{name} increase=False",
                      lambda kern=kern: kern(qd, Qd, W, increase=False),
                      lambda plain=plain: plain(qd, Qd, W, increase=False),
                      KERNEL_BOUNDS[name]))
    for v2 in (False, True):
        name = "lwa_dense_v2" if v2 else "lwa_dense"
        for inc, qq, QQ in ((True, q, Q), (False, qd, Qd)):
            for part in ("all", "upper", "lower"):
                kw = dict(increase=inc, part=part, variant2=v2)
                cases.append((f"{name} increase={inc} {part}",
                              lambda kw=kw, qq=qq, QQ=QQ: lwa.lwa_dense(qq, QQ, W, **kw),
                              lambda kw=kw, qq=qq, QQ=QQ: lwa.lwa_dense_plain(qq, QQ, W, **kw),
                              KERNEL_BOUNDS[name]))
    return cases


def k8_crossed_cells(q0, lv, window, stride):
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


def k8_instructions(Ny, Nx, Wy, Wx, window, stride, pairs):
    """K8's least FP32 work: CLASSIFY_INSTR for each field cell a window
    covers, PRETEST_INSTR for each (window, lattice block it covers) and
    SEGMENT_INSTR (sphere) for each crossed (window, cell) pair; a window
    of window - 1 cells a side covers ceil((window - 1) / stride) blocks a
    side."""
    cells = window - 1
    covered = ((Wy - 1) * min(stride, cells) + cells) \
        * ((Wx - 1) * min(stride, cells) + cells)
    nbw = -(-cells // stride)
    assert covered <= (Ny - 1) * (Nx - 1)
    return (CLASSIFY_INSTR * covered + PRETEST_INSTR * Wy * Wx * nbw ** 2
            + SEGMENT_INSTR[True] * pairs)


def length_cases(era_q, era_grid, head_q, local_q):
    """name -> (bound key, kernel call, float32 plain call, float64 plain
    call, (bytes, instructions), crossed pairs) for K7 at ERA5 (lat-lon,
    N = 121 and 401) and at the headline shape (Cartesian, 10 km spacing,
    N = 121), and K8 at its rolling-mean levels: on the LOCAL_B levels
    local_q of an ERA5 step in one launch at LOCAL, as
    local_length_pipeline runs it, and on one ERA5 snapshot at K8_WINDOWS.
    K7's instructions count CLASSIFY_INSTR per cell and SEGMENT_INSTR per
    crossed pair, counted from the inputs; K8's, k8_instructions summed
    over the fields."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.kernels import length

    def k7(q, ctr, yc, xc, latlon):
        d = lambda a: a.double()
        pairs = k7_crossed_pairs(q, ctr)
        return ("contour_lengths",
                lambda: length.contour_lengths(q, ctr, yc, xc, latlon=latlon),
                lambda: length.contour_lengths_plain(q, ctr, yc, xc,
                                                     latlon=latlon, chunk=2),
                lambda: length.contour_lengths_plain(d(q), d(ctr), d(yc),
                                                     d(xc), latlon=latlon,
                                                     chunk=2),
                k7_work(q, ctr, yc, xc, latlon, pairs), pairs)
    yc = torch.deg2rad(era_grid.ydef).contiguous()
    xc = torch.deg2rad(era_grid.xdef).contiguous()
    cases = {f"contour_lengths_n{N}": k7(era_q, xt.cal_contours(era_q, N),
                                         yc, xc, True)
             for N in CLENGTH_N}
    B, Ny, Nx = head_q.shape
    hy = torch.arange(Ny, dtype=torch.float32, device=head_q.device) * 1e4
    hx = torch.arange(Nx, dtype=torch.float32, device=head_q.device) * 1e4
    cases["contour_lengths_cartesian"] = k7(
        head_q, xt.cal_contours(head_q, HEADLINE["N"]), hy, hx, False)
    q0 = era_q[0].contiguous()
    for tag, q, window, stride in (
            ("", local_q.contiguous(), LOCAL["window"], LOCAL["stride"]),
            *((f"_w{w}s{s}", q0, w, s) for w, s in K8_WINDOWS)):
        lv = xt.rolling_mean(q, window, stride)[0].contiguous()
        kw = dict(window=window, stride=stride, latlon=True)
        fields = list(zip(q.reshape(-1, *q.shape[-2:]),
                          lv.reshape(-1, *lv.shape[-2:])))
        each = [k8_crossed_cells(f, v, window, stride) for f, v in fields]
        cases["local_lengths" + tag] = (
            "local_lengths",
            lambda q=q, lv=lv, kw=kw: length.local_lengths(q, lv, yc, xc,
                                                           **kw),
            lambda q=q, lv=lv, kw=kw: length.local_lengths_plain(
                q, lv, yc, xc, **kw),
            lambda q=q, lv=lv, kw=kw: length.local_lengths_plain(
                q.double(), lv.double(), yc.double(), xc.double(), **kw),
            (4 * (q.numel() + 2 * lv.numel() + yc.numel() + xc.numel()),
             sum(k8_instructions(*q0.shape, *lv.shape[-2:], window, stride, p)
                 for p in each)),
            sum(each))
    return cases


def queue3_case(seed, B, Ny, Nx, dev):
    """tests/test_torch_lwa.py's _case at any shape (Ny >= 40, Nx >= 64):
    sorted profiles, NaN cells, +inf cells, a -inf (surface) cell, a NaN
    profile row, a NaN weight, an infinite weight and an exact
    tracer-profile tie."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Ny, Nx)).cumsum(1) * 0.3
    Q = np.sort(rng.standard_normal((B, Ny)) * 2.0, axis=-1)
    W = rng.uniform(0.5, 1.5, (Ny, Nx))
    q[0, 3:5, 7:11] = np.nan
    Q[1, 6] = np.nan
    q[1, 9, 2] = Q[1, 20]
    q[0, 12, 40] = np.inf
    q[1, 30, 41] = -np.inf
    q[1, 32, 43] = np.inf
    W[25, 60] = np.nan
    W[33, 70] = np.inf
    T = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return T(q), T(Q), T(W)


def queue3_checks(dev):
    """K3 and K4's 12 instances (K6 at Ny > 3072) on the inputs where the
    TPU kernel and the XLA twin differ: the kernel must give the plain
    version's NaN pattern (the twin's inf * 0 = NaN) within the bounds."""
    from xcontour_tpu_torch.kernels import lwa
    for shape in QUEUE3_SHAPES:
        label = "x".join(map(str, shape))
        q, Q, W = queue3_case(4, *shape, dev)
        tall = shape[1] > lwa.TALL_NY
        nans = []
        for v2 in (False, True):
            for inc in (True, False):
                for part in ("all", "upper", "lower"):
                    kw = dict(increase=inc, part=part, variant2=v2)
                    got = lwa.lwa_dense(q, Q, W, **kw)
                    want = lwa.lwa_dense_plain(q, Q, W, **kw)
                    _, rel = rel_err(got, want)
                    key = ("lwa_dense_tall" if tall else "lwa_dense") + \
                        ("_v2" if v2 else "")
                    _expect(rel <= KERNEL_BOUNDS[key],
                            f"queue-3 {label} {kw}: rel {rel:.3e}")
                    nans.append(int(torch.isnan(want).sum()))
        for inc in (True, False):
            got = lwa.lwa_lin(q, Q, W, increase=inc)
            _, rel = rel_err(got, lwa.lwa_lin_plain(q, Q, W, increase=inc))
            _expect(rel <= KERNEL_BOUNDS["lwa_lin"] and
                    bool((got[1, 6] == 0).all()),
                    f"queue-3 {label} lwa_lin increase={inc}: rel {rel:.3e}")
        _expect(min(nans) > 0, f"queue-3 {label}: an instance without NaN")
        log(f"phase 3 queue-3 inputs {label}: K4's 12 instances and K3 "
            f"(both directions) match the plain versions, NaN patterns "
            f"included (NaN cells per K4 instance {nans})")


def odd_shape_checks(dev):
    """The kernel paths no pipeline shape reaches: K1 and its copy probe
    P4 at one column a lane (a row length of 182, 2 mod 4; 361, odd; and
    360 read through a view one float off 16-byte alignment) and on rows
    longer than ERA5's (8192 columns at four a lane, 8190 and a view off
    alignment at one), K1 in all six modes, bit for bit; K2 with nine
    channels (a group of 8 and one of 1) on uneven edges, with values below
    e[0], on interior edges and on the top edge, NaN values and NaN
    weights, within its bound and the NaN pattern."""
    from xcontour_tpu_torch.kernels import gradw, hist, probes, stencil
    rng = np.random.default_rng(9)
    rg = np.random.default_rng(10)     # G's spacings and areas
    T = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    for Nx, offset in ((182, 0), (361, 0), (360, 1), (8192, 0), (8190, 0),
                       (8192, 1)):
        Ny = 45
        q = rng.standard_normal((3, Ny, Nx)).cumsum(-1).cumsum(-2)
        q[0, 1, Nx // 2] = np.nan      # the 'reflect' walls read row 1
        q[2, Ny // 2, Nx // 3] = np.nan
        flat = torch.empty(q.size + offset, dtype=torch.float32, device=dev)
        qv = flat[offset:].view(q.shape)
        qv.copy_(T(q))
        rdx = T(1.0 / rng.uniform(0.5, 2.0, (Ny, Nx)))
        rdy = T(1.0 / rng.uniform(0.5, 2.0, Ny))
        for periodic in (True, False):
            for bc in ("extend", "fill", "reflect"):
                kw = dict(periodic_x=periodic, bc_y=bc)
                err, _ = rel_err(stencil.squared_gradient(qv, rdx, rdy, **kw),
                                 stencil.squared_gradient_plain(qv, rdx, rdy,
                                                                **kw))
                _expect(err == 0.0, f"squared_gradient Nx={Nx} offset "
                        f"{offset} {kw}: max_abs_err {err:.3e}, not exact")
        _expect(same_bits(probes.scaled_copy(qv), probes.scaled_copy_plain(qv)),
                f"{probes.KERNEL_COPY.name} Nx={Nx} offset {offset}: differs "
                f"from q * {probes.SCALE}")
        # G on the same view with a flat patch (|grad q| = 0)
        gflat = torch.empty_like(flat)
        qg = gflat[offset:].view(q.shape)
        qg.copy_(qv)
        qg[1, 10:14, 20:30] = 0.5
        sx, sy, da = (T(rg.uniform(0.5, 2.0, s)) for s in ((Ny, Nx), Ny,
                                                           (Ny, Nx)))
        for periodic in (True, False):
            for bc in ("extend", "fill", "reflect"):
                kw = dict(periodic_x=periodic, bc_y=bc)
                _expect(same_bits(
                    gradw.clength_weights(qg, sx, sy, da, **kw),
                    gradw.clength_weights_plain(qg, sx, sy, da, **kw)),
                    f"clength_weights Nx={Nx} offset {offset} {kw}: differs "
                    "from its plain version")
        lanes = 4 if Nx % 4 == 0 and qv.data_ptr() % 16 == 0 else 1
        log(f"phase 3 odd shapes squared_gradient 3x{Ny}x{Nx} offset "
            f"{offset} ({lanes} column(s) a lane): six modes bit for bit OK; "
            f"{probes.KERNEL_COPY.name} bit for bit OK; clength_weights six "
            "modes bit for bit OK")
    B, G, N, C = 3, 50 * 97, 17, 9
    v = rng.standard_normal((B, G))
    e = np.sort(rng.standard_normal((B, N + 1)), -1)
    v[:, :40] = e[:, 5:6]                # an interior edge
    v[:, 40:60] = e[:, -1:]              # the top edge
    v[:, 60:80] = e[:, :1] - 1.0         # below e[0]
    v[1, 100:130] = np.nan
    w = rng.uniform(0.5, 1.5, (B, C, G))
    w[0, 8, 200:230] = np.nan
    w[2, 3, 300] = np.nan
    v, e, w = T(v), T(e), T(w)
    got, want = hist.weighted_cdf(v, e, w), hist.weighted_cdf_plain(v, e, w)
    err, rel = rel_err(got, want)
    bound = KERNEL_BOUNDS["weighted_cdf"]
    _expect(rel <= bound, f"weighted_cdf C={C}: rel {rel:.3e}")
    log(f"phase 3 odd shapes weighted_cdf B={B} G={G} N={N} C={C}: "
        f"max_abs_err {err:.6g} rel {rel:.3e} bound {bound:g} OK")


def check_length_kernel(name, bound_key, kern, plain, plain64):
    """K7 or K8 against its plain version run in float64 on the same card
    inputs, beside the float32 plain version's own error; the empty
    contours (exact zeros) must agree, and a second run must give the same
    bits.  Returns the kernel's max abs error."""
    got, p32, want = kern(), plain(), plain64()
    torch.cuda.synchronize()
    _expect(torch.equal(kern(), got), f"{name}: two runs differ")
    log(f"phase 3 kernel {name}: two runs bit for bit OK")
    for label, x in (("kernel", got), ("float32 plain version", p32)):
        _expect(torch.equal(x == 0, want == 0),
                f"{name}: the {label}'s empty contours differ from the "
                "float64 plain version's")
    err, rel = rel_err(got, want)
    perr, prel = rel_err(p32, want)
    bound = KERNEL_BOUNDS[bound_key]
    ok = rel <= bound
    log(f"phase 3 kernel {name} {tuple(got.shape)}: against float64 plain: "
        f"kernel max_abs_err {err:.6g} rel {rel:.3e}, float32 plain "
        f"max_abs_err {perr:.6g} rel {prel:.3e}; bound {bound:g} "
        f"{'OK' if ok else 'FAIL'}")
    _expect(ok, f"{name} disagrees with its float64 plain version")
    return err


def tie_checks(dev):
    """The exact-empty rule on the card: K7 on 256 seeded 12x14 fields at
    [min, mid, max] (lat-lon and Cartesian) and K8 on 64 windows of 9x9
    cells at their own minimum give exactly 0 at every min level, max level
    and window minimum (the TPU kernels' reciprocal edge fractions leave
    ulps of length there)."""
    from xcontour_tpu_torch.kernels import length
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    rng = np.random.default_rng(7)
    d = rng.normal(size=(256, 12, 14)) * rng.uniform(0.1, 1000.0, (256, 1, 1)) \
        + rng.uniform(-50.0, 50.0, (256, 1, 1))
    lo, hi = d.min(axis=(1, 2)), d.max(axis=(1, 2))
    lev = np.stack([lo, 0.5 * (lo + hi), hi], axis=1)
    for latlon, y, x in ((True, np.deg2rad(np.linspace(-60, 60, 12)),
                          np.deg2rad(np.linspace(0, 348, 14))),
                         (False, np.linspace(0, 1900, 12),
                          np.linspace(0, 2900, 14))):
        out = length.contour_lengths(T(d), T(lev), T(y), T(x), latlon=latlon)
        zeros = [int((out[:, k] == 0).sum()) for k in range(3)]
        log(f"phase 3 tie K7 latlon={latlon}: exact zeros at [min, mid, max] "
            f"{zeros} of 256")
        _expect(zeros == [256, 0, 256],
                f"K7 breaks the exact-empty rule (latlon={latlon})")
    rng = np.random.default_rng(7)
    f = rng.normal(size=(80, 80)) * rng.uniform(0.1, 1000.0) \
        + rng.uniform(-50.0, 50.0)
    wmin = f.reshape(8, 10, 8, 10).min(axis=(1, 3))
    out = length.local_lengths(T(f), T(wmin),
                               T(np.deg2rad(np.linspace(-60, 60, 80))),
                               T(np.deg2rad(np.linspace(0, 300, 80))),
                               window=10, stride=10, latlon=True)
    zeros = int((out == 0).sum())
    log(f"phase 3 tie K8: exact zeros at the window minima {zeros} of 64")
    _expect(zeros == 64, "K8 breaks the exact-empty rule")


def k8_batch_checks(era_q, era_grid):
    """K8 on every level of an ERA5 step (LOCAL_B levels) in one launch
    against the 2-D K8 on each level, bit for bit, at LOCAL and at each of
    K8_WINDOWS, at the levels' rolling means: one launch a call, batch or
    not.  (length_cases holds the same launch at LOCAL against the float64
    plain version.)"""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.kernels import length
    yc = torch.deg2rad(era_grid.ydef).contiguous()
    xc = torch.deg2rad(era_grid.xdef).contiguous()
    K = length.KERNEL_LOCAL_LENGTHS
    for window, stride in ((LOCAL["window"], LOCAL["stride"]), *K8_WINDOWS):
        lv = xt.rolling_mean(era_q, window, stride)[0].contiguous()
        kw = dict(window=window, stride=stride, latlon=True)
        n0 = K.launches
        got = length.local_lengths(era_q, lv, yc, xc, **kw)
        _expect(K.launches == n0 + 1, f"K8 batch {window} / {stride}: "
                f"{K.launches - n0} launches, not 1")
        want = torch.stack([length.local_lengths(
            era_q[b].contiguous(), lv[b].contiguous(), yc, xc, **kw)
            for b in range(era_q.shape[0])])
        _expect(K.launches == n0 + 1 + era_q.shape[0],
                f"K8 2-D {window} / {stride}: a launch a level expected")
        _expect(same_bits(got, want), f"K8 batch {window} / {stride}: "
                "differs from the 2-D kernel level by level")
        log(f"phase 3 K8 batch {tuple(era_q.shape)} window {window} / stride "
            f"{stride}: one launch, {tuple(got.shape)} bit for bit with "
            f"{era_q.shape[0]} 2-D launches OK")
    # past CUDA's 65,535 grid y: a launch a 65,535 fields inside one call
    rng = np.random.default_rng(11)
    f = torch.as_tensor(rng.standard_normal((LIMIT_B, 4, 8)),
                        dtype=torch.float32, device=era_q.device)
    fy = torch.linspace(0.0, 0.3, 4, device=era_q.device)
    fx = torch.linspace(0.0, 0.7, 8, device=era_q.device)
    lv = xt.rolling_mean(f, 3, 1)[0].contiguous()
    kw = dict(window=3, stride=1, latlon=True)
    n0 = K.launches
    got = length.local_lengths(f, lv, fy, fx, **kw)
    _expect(K.launches == n0 + 1, "K8 batch past 65,535 fields: one call")
    for b in sorted({0, 65534, 65535, LIMIT_B - 1} & set(range(LIMIT_B))):
        want = length.local_lengths(f[b].contiguous(), lv[b].contiguous(), fy,
                                    fx, **kw)
        _expect(same_bits(got[b], want),
                f"K8 batch of {LIMIT_B} fields: field {b} differs")
    log(f"phase 3 K8 batch of {LIMIT_B} fields of 4x8 (window 3 / stride 1):"
        " fields 0, 65534, 65535 and the last bit for bit with 2-D launches OK")


def decode_cases(dev):
    """{name: (kernel, plain, host chunk, (bytes, 0))} of DECODE_CASES: the
    raw planes of a _LazyField over an ndarray of the file's dtype (the nc3
    memmap's layout) on the card, their decode by the kernel and by the
    plain version, and the host path's chunk field[rows]."""
    from xcontour_tpu_torch import cli
    from xcontour_tpu_torch.kernels import decode
    B, Ny = DECODE["B"], DECODE["nlat"]
    _, _, pv = make_pv(B, Ny, DECODE["nlon"], DECODE["seed"])
    rng = np.random.default_rng(DECODE["seed"])
    cases = {}
    for name, fdt, rdt, flip, masked, Nx in DECODE_CASES:
        src = np.ascontiguousarray(pv[..., :Nx], dtype=fdt)
        mask = ((rng.uniform(size=(Ny, Nx)) > 0.1).astype(rdt)
                if masked else None)
        f = cli._LazyField(src, ("level", "latitude", "longitude"), {}, None,
                           (), mask, rdt, flip_y=flip)
        planes = f.raw_planes()
        _expect(planes is not None, f"decode {name}: no raw planes offered")
        raw = np.empty((B, Ny, Nx * src.itemsize), np.uint8)
        f.raw_into(slice(0, B), raw)
        raw = torch.from_numpy(raw).to(dev)
        m = None if planes.mask is None else \
            torch.from_numpy(planes.mask).to(dev)
        nbytes = B * Ny * Nx * (src.itemsize + np.dtype(rdt).itemsize) \
            + (Ny * Nx if masked else 0)
        cases[name] = (
            lambda raw=raw, planes=planes, m=m:
                decode.decode_planes(raw, planes, m),
            lambda raw=raw, planes=planes, m=m:
                decode.decode_planes_plain(raw, planes, m),
            f[0:B], (nbytes, 0))
    return cases


def decode_checks(dev, errs):
    """Phase 3, D: the kernel (one launch a call) against its plain version
    on the same card tensors and against the host path's chunk, NaN at the
    same cells and every other cell bit for bit, at each of DECODE_CASES."""
    from xcontour_tpu_torch.kernels import decode
    for name, (kern, plain, want, _) in decode_cases(dev).items():
        before = decode.KERNEL.launches
        got = kern()
        _expect(decode.KERNEL.launches == before + 1,
                f"decode {name}: {decode.KERNEL.launches - before} launches "
                "for one call")
        ok_plain = same_bits(got, plain())
        ok_host = same_bits(got, torch.from_numpy(want).to(dev))
        log(f"phase 3 check decode_planes {name} {tuple(got.shape)} "
            f"{got.dtype}: against the plain version on the card "
            f"{'bit for bit' if ok_plain else 'FAIL'}, against the host "
            f"path's chunk {'bit for bit' if ok_host else 'FAIL'} "
            f"({int(torch.isnan(got).sum())} NaN cells)")
        _expect(ok_plain and ok_host, f"decode {name}: the kernel's chunk "
                "differs from the plain version's or the host path's")
        errs[f"decode_{name}"] = 0.0


def boxcount_case(q, grid, N):
    """B at the fractal path's call: (kernel, plain, plain in float64,
    work) on the field and areas padded by the largest stride."""
    from xcontour_tpu_torch import core
    from xcontour_tpu_torch.diagnostics import length as dlength
    from xcontour_tpu_torch.kernels import boxcount
    ctr = core.cal_contours(q, N)
    pad = max(FRACTAL_STRIDES)
    d = dlength._pad_x(q, pad, "edge")
    a = dlength._pad_x(grid.dA.to(q.dtype), pad, "edge")
    B, Ny, W = d.shape
    return (lambda: boxcount.box_counts(d, ctr, a, FRACTAL_STRIDES),
            lambda: boxcount.box_counts_plain(d, ctr, a, FRACTAL_STRIDES,
                                              False),
            lambda: boxcount.box_counts_plain(d.double(), ctr.double(),
                                              a.double(), FRACTAL_STRIDES,
                                              False),
            boxcount_work(B, Ny, W, N, FRACTAL_STRIDES))


def boxcount_checks(q, grid, N, errs):
    """Phase 3, B: one launch a call, two runs bit for bit, within
    BOX_BOUND of the plain version run in float64 (the float32 plain
    version's own error beside it), the same finite totals."""
    from xcontour_tpu_torch.kernels import boxcount
    kern, plain, plain64, _ = boxcount_case(q, grid, N)
    before = boxcount.KERNEL.launches
    got = kern()
    _expect(boxcount.KERNEL.launches == before + 1,
            f"box_counts: {boxcount.KERNEL.launches - before} launches for "
            "one call")
    _expect(same_bits(got, kern()), "box_counts: two runs differ")
    want = plain64()
    err, rel = rel_err(got.double(), want)
    _, rel32 = rel_err(plain().double(), want)
    ok = rel <= BOX_BOUND
    log(f"phase 3 kernel box_counts {tuple(got.shape)}: two runs bit for bit "
        f"OK; against float64 plain: max_abs_err {err:.6g} rel {rel:.3e} "
        f"(float32 plain {rel32:.3e}) bound {BOX_BOUND:g} "
        f"{'OK' if ok else 'FAIL'}")
    _expect(ok, "box_counts disagrees with its plain version")
    errs["box_counts"] = err


def rolling_checks(era_q, errs):
    """Phase 3, R (the window means) on the LOCAL_B levels of an ERA5 step,
    as local_length_pipeline calls it, and at each of K8_WINDOWS: one
    launch a call, two runs bit for bit, every mean within one float32 ulp
    of the float64 direct means (R's float64 sums are rounded once), and
    the plain version's integral images on the same card inputs beside
    it.  The float64 means are the benchmark's plain reference's
    (``xcbench/reference/local.py``: plain torch, none of the port)."""
    from xcbench.reference.local import window_means as direct_window_means
    from xcontour_tpu_torch.kernels import rolling
    for window, stride in ((LOCAL["window"], LOCAL["stride"]), *K8_WINDOWS):
        n0 = rolling.KERNEL.launches
        got = rolling.window_means(era_q, window, stride)
        _expect(rolling.KERNEL.launches == n0 + 1,
                f"window_means {window} / {stride}: "
                f"{rolling.KERNEL.launches - n0} launches, not 1")
        _expect(same_bits(got, rolling.window_means(era_q, window, stride)),
                f"window_means {window} / {stride}: two runs differ")
        exact = direct_window_means(era_q.double(), window, stride)
        plain = rolling.window_means_plain(era_q, window, stride)
        _expect(torch.equal(torch.isnan(got), torch.isnan(exact)),
                f"window_means {window} / {stride}: NaN windows differ")
        m = ~torch.isnan(exact)
        gap = (got.double() - exact)[m].abs()
        ulp = (torch.nextafter(got.abs(), torch.full_like(got, float("inf")))
               - got.abs()).double()[m]
        worst = float((gap / ulp).max())
        err = float(gap.max())
        plain_err = float((plain.double() - exact)[m].abs().max())
        ok = worst <= 1.0
        log(f"phase 3 kernel window_means {tuple(got.shape)} window {window} "
            f"/ stride {stride}: one launch, two runs bit for bit; against "
            f"float64 direct means max_abs_err {err:.6g} ({worst:.3f} float32 "
            f"ulp; the plain version's integral images {plain_err:.6g}) "
            f"{'OK' if ok else 'FAIL'}")
        _expect(ok, "window_means is not within a float32 ulp of the "
                "float64 means")
        if window == LOCAL["window"] and stride == LOCAL["stride"]:
            errs["window_means"] = err


def limit_checks(dev, era_q, era_grid):
    """The port's launch limits, each against its plain version: K2-K5
    and K7 at a batch of LIMIT_B snapshots of 4x8 (past CUDA's 65,535 grid
    y and z), K8 with 65,599 window rows (window 2, stride 1 on 65,600x8;
    the plain version loops over window rows, so it runs on the first 65
    and the last 100 rows of the field), K2 at 16 channels x 4,000 bins
    (two channel groups) and 2 x 20,000 (two bin ranges), K7 at 5,000
    levels (five level chunks) with NaN levels, in any order.  The
    K8 windows of K8_WINDOWS are length_cases'."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.kernels import hist, length, lwa
    rng = np.random.default_rng(12)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                  device=dev)
    B, Ny, Nx = LIMIT_B, 4, 8
    q = rng.standard_normal((B, Ny, Nx)).cumsum(1).cumsum(2)
    q[7, 1, 2] = np.nan
    q, W = T(q), T(rng.uniform(0.5, 1.5, (Ny, Nx)))
    Q = torch.sort(q.reshape(B, -1)[:, ::8].nan_to_num(0.0), -1).values
    Q = Q.contiguous()
    for name, kern, plain, bound in (
            ("lwa_lin", lambda: lwa.lwa_lin(q, Q, W, increase=True),
             lambda: lwa.lwa_lin_plain(q, Q, W, increase=True), "lwa_lin"),
            ("lwa_lin2", lambda: lwa.lwa_lin2(q, Q, W, increase=True),
             lambda: lwa.lwa_lin2_plain(q, Q, W, increase=True), "lwa_lin2"),
            ("lwa_dense", lambda: lwa.lwa_dense(q, Q, W, increase=True),
             lambda: lwa.lwa_dense_plain(q, Q, W, increase=True),
             "lwa_dense"),
            ("lwa_dense_v2",
             lambda: lwa.lwa_dense(q, Q, W, increase=False, variant2=True),
             lambda: lwa.lwa_dense_plain(q, Q, W, increase=False,
                                         variant2=True), "lwa_dense_v2")):
        check_kernel("limit", bound, kern, plain, (B, Ny, Nx))
    v = q.reshape(B, -1).contiguous()
    e = torch.sort(T(rng.standard_normal((B, 6))), -1).values.contiguous()
    w = T(rng.uniform(0.5, 1.5, (B, 2, Ny * Nx)))
    check_kernel("limit", "weighted_cdf", lambda: hist.weighted_cdf(v, e, w),
                 lambda: hist.weighted_cdf_plain(v, e, w), (B, Ny * Nx))
    lev = T(rng.standard_normal((B, 5)) * 3.0)
    lev[3, 2] = float("nan")
    yc = T(np.linspace(0.0, 0.3, Ny))
    xc = T(np.linspace(0.0, 0.7, Nx))
    d = lambda a: a.double()
    check_length_kernel(
        f"contour_lengths batch {B}", "contour_lengths",
        lambda: length.contour_lengths(q, lev, yc, xc, latlon=True),
        lambda: length.contour_lengths_plain(q, lev, yc, xc, latlon=True),
        lambda: length.contour_lengths_plain(d(q), d(lev), d(yc), d(xc),
                                             latlon=True))
    # K8 past 65,535 window rows: noise on cells of comparable extent (a
    # random walk down the rows, its columns drifting apart, would make
    # every contour nearly parallel to y, where float32 edge fractions
    # leave 5e-6 of the longest window's length: the plain version's
    # float32 arithmetic, not the kernel's sums)
    f = T(rng.standard_normal((LIMIT_ROWS, 8)))
    fy = T(np.linspace(-1.2, 1.2, LIMIT_ROWS))
    fx = T(np.linspace(0.0, 5e-4, 8))
    kw = dict(window=2, stride=1, latlon=True)
    lv = xt.rolling_mean(f, 2, 1)[0].contiguous()
    got = length.local_lengths(f, lv, fy, fx, **kw)
    torch.cuda.synchronize()
    wy = LIMIT_ROWS - 1
    for rows in (slice(0, 64), slice(wy - 99, wy)):
        part = slice(rows.start, rows.stop + 1)
        want = length.local_lengths_plain(d(f[part]), d(lv[rows]), d(fy[part]),
                                          d(fx), **kw)
        _expect(torch.equal(got[rows] == 0, want == 0),
                "local_lengths 65,599 window rows: empty windows differ")
        err, rel = rel_err(got[rows], want)
        _expect(rel <= KERNEL_BOUNDS["local_lengths"],
                f"local_lengths window rows {rows}: rel {rel:.3e}")
        log(f"phase 3 limit local_lengths {tuple(got.shape)} window rows "
            f"[{rows.start}, {rows.stop}): max_abs_err {err:.6g} rel "
            f"{rel:.3e} bound {KERNEL_BOUNDS['local_lengths']:g} OK")
    # K2 in two channel groups and in two bin ranges
    for C, N in ((16, 4000), (2, 20000)):
        G = 200_000
        vv = rng.standard_normal((2, G))
        vv[0, :500] = np.nan
        ee = np.sort(rng.standard_normal((2, N + 1)) * 1.2, -1)
        ww = rng.uniform(0.5, 1.5, (2, C, G))
        ww[1, C - 1, 1000:1100] = np.nan
        vv, ee, ww = T(vv), T(ee), T(ww)
        _expect(hist.bin_range(N, C) == (N if C == 16 else 19370),
                f"weighted_cdf C={C} N={N}: bin range "
                f"{hist.bin_range(N, C)}")
        check_kernel("limit", "weighted_cdf",
                     lambda: hist.weighted_cdf(vv, ee, ww),
                     lambda: hist.weighted_cdf_plain(vv, ee, ww),
                     f"C={C} N={N} G={G}")
    # K7 over five chunks of levels, NaN levels, any order
    lat, lon, pv = make_pv(3, 64, 96, 5)
    kq = T(pv)
    lo = torch.nan_to_num(kq, nan=float("inf")).amin((-2, -1))
    hi = torch.nan_to_num(kq, nan=float("-inf")).amax((-2, -1))
    u = T(rng.permutation(np.linspace(0.0, 1.0, 5000)))
    kl = (lo[:, None] + (hi - lo)[:, None] * u[None]).contiguous()
    kl[1, 17] = float("nan")
    ky, kx = T(np.deg2rad(lat)), T(np.deg2rad(lon))
    check_length_kernel(
        "contour_lengths N=5000", "contour_lengths",
        lambda: length.contour_lengths(kq, kl, ky, kx, latlon=True),
        lambda: length.contour_lengths_plain(kq, kl, ky, kx, latlon=True,
                                             chunk=64),
        lambda: length.contour_lengths_plain(d(kq), d(kl), d(ky), d(kx),
                                             latlon=True, chunk=64))


def _unique_min(q):
    """Batch elements whose minimum is attained once: only there must the
    minimum level be empty (a tie of two corners is a real segment)."""
    qn = torch.where(torch.isnan(q), torch.full_like(q, float("inf")), q)
    return (qn == qn.amin(dim=(-2, -1), keepdim=True)).sum(dim=(-2, -1)) == 1


def check_clength(out, q, N, where):
    """clength_pipeline's outputs: shapes, the maximum level empty (NaN),
    the minimum level too where the minimum is unique, interior lengths
    finite and positive.  Returns the share of interior levels with
    Leq >= L >= Lmin within 1e-3 (informational)."""
    B = q.shape[0]
    _shapes(out, {k: (B, N) for k in out}, where)
    _finite(out, ("contour", "intArea", "Yeq", "Lmin"), where)
    L = out["lengths"]
    _expect(bool(torch.isnan(L[:, -1]).all()), f"{where}: max level not empty")
    _expect(bool(torch.isnan(L[_unique_min(q), 0]).all()),
            f"{where}: a unique minimum's level is not empty")
    inner = L[:, 1:-1]
    _expect(bool(torch.isfinite(inner).all() and (inner > 0).all()),
            f"{where}: an interior length is not finite and positive")
    Leq = torch.sqrt(out["Leq2"][:, 1:-1])
    chain = (Leq * (1 + 1e-3) >= inner) & (inner * (1 + 1e-3) >= out["Lmin"][:, 1:-1])
    return chain.double().mean().item()


def check_fractal(out, q, N, where):
    """fractal_pipeline's outputs: shapes; at stride 1 the maximum level
    empty, the minimum too where unique, interior lengths finite and
    positive; every finite length positive; the median D in [1, 2) (a
    plane curve, examples/ex4_contour_length.py).  Returns the medians of
    D and D_bc."""
    B, S = q.shape[0], len(FRACTAL_STRIDES)
    _shapes(out, dict(contour=(B, N), Yeq=(B, N), lengths=(B, N, S),
                      rulers=(B, N, S), D=(B, N), bclens=(B, N, S),
                      D_bc=(B, N)), where)
    L = out["lengths"]
    _expect(bool(torch.isnan(L[:, -1, 0]).all()), f"{where}: max level not empty")
    _expect(bool(torch.isnan(L[_unique_min(q), 0, 0]).all()),
            f"{where}: a unique minimum's level is not empty")
    inner = L[:, 1:-1, 0]
    _expect(bool(torch.isfinite(inner).all() and (inner > 0).all()),
            f"{where}: an interior stride-1 length is not finite and positive")
    _expect(bool((L[torch.isfinite(L)] > 0).all()), f"{where}: a length <= 0")
    med = torch.nanmedian(out["D"]).item()
    _expect(1.0 <= med < 2.0, f"{where}: median D {med} outside [1, 2)")
    return med, torch.nanmedian(out["D_bc"]).item()


def check_local(outs, where):
    """local_contour_lengths on each level: (Wy, Wx) lengths, every window
    finite and positive (its level is its own mean), centres of length
    Wy and Wx."""
    for lengths, cy, cx in outs:
        _expect(lengths.shape == (cy.shape[0], cx.shape[0]),
                f"{where}: lengths {tuple(lengths.shape)} vs centres "
                f"{tuple(cy.shape)}, {tuple(cx.shape)}")
        _expect(bool(torch.isfinite(lengths).all() and (lengths > 0).all()),
                f"{where}: a window length is not finite and positive")


def _expect(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _finite(out, keys, where):
    for k in keys:
        _expect(bool(torch.isfinite(out[k]).all()),
                f"{where}: {k} has non-finite values")


def _shapes(out, shapes, where):
    for k, shape in shapes.items():
        _expect(tuple(out[k].shape) == shape,
                f"{where}: {k} has shape {tuple(out[k].shape)}")


def _monotone(x, where, name):
    _expect(bool((torch.diff(x, dim=-1) >= 0).all()),
            f"{where}: {name} is not monotone")


def _in_range(x, lo, hi, where, name):
    _expect(bool(((x >= lo) & (x <= hi)).all()),
            f"{where}: {name} outside [{lo}, {hi}]")


def _check_keff(out, where):
    """What the JAX semantics guarantee for the Keff keys: Leq2 NaN only
    where the enclosed area does not change between neighbouring contours,
    never infinite or negative; nkeff the same, NaN also at and above its
    threshold."""
    from xcontour_tpu_torch.ops.gradient import gradient_index
    flat = gradient_index(out["intArea"]) == 0
    leq2, nkeff = out["Leq2"], out["nkeff"]
    _expect(not (bool((torch.isnan(leq2) & ~flat).any())
                 or bool(torch.isinf(leq2).any())
                 or bool((leq2[~torch.isnan(leq2)] < 0).any())),
            f"{where}: Leq2 negative, infinite or NaN where the area changes")
    _expect(not (bool(torch.isinf(nkeff).any())
                 or bool((nkeff[~torch.isnan(nkeff)] < 0).any())),
            f"{where}: nkeff outside [0, 2e7) or NaN")
    _monotone(out["intArea"], where, "intArea")
    _monotone(out["intgrdS"], where, "intgrdS")
    _in_range(out["Yeq"], -90.0, 90.0, where, "Yeq")


def check_step(out, B, Ny, N, where):
    """keff_lwa_pipeline's outputs."""
    _shapes(out, dict(contour=(B, N), intArea=(B, N), intgrdS=(B, N),
                      Yeq=(B, N), Lmin=(B, N), Leq2=(B, N), nkeff=(B, N),
                      Q=(B, Ny)), where)
    _finite(out, [k for k in ("contour", "intArea", "intgrdS", "Yeq", "Lmin",
                              "Q", "lwa", "lwa2") if k in out], where)
    _check_keff(out, where)


def check_lwa_step(out, shape, N, lo, hi, where):
    """lwa_pipeline's outputs: every key finite, areas monotone, latEq
    within the grid's coordinate range."""
    B, Ny, Nx = shape
    _shapes(out, dict(contour=(B, N), intArea=(B, N), latEq=(B, N),
                      Q=(B, Ny), lwa=shape, lwa2=shape), where)
    _finite(out, out.keys(), where)
    _monotone(out["intArea"], where, "intArea")
    _in_range(out["latEq"], lo, hi, where, "latEq")


def check_split_step(out, shape, N, where):
    """lwa_pipeline(part='split')'s outputs: the four halves in place of
    lwa and lwa2, every key finite, areas monotone, LWA's halves >= 0 and
    LWA2's <= 0 (an increasing tracer)."""
    B, Ny, Nx = shape
    _shapes(out, dict(contour=(B, N), intArea=(B, N), latEq=(B, N),
                      Q=(B, Ny), lwa_upper=shape, lwa_lower=shape,
                      lwa2_upper=shape, lwa2_lower=shape), where)
    _finite(out, out.keys(), where)
    _monotone(out["intArea"], where, "intArea")
    for k, sign in (("lwa_upper", 1), ("lwa_lower", 1), ("lwa2_upper", -1),
                    ("lwa2_lower", -1)):
        _expect(bool((sign * out[k] >= 0).all()), f"{where}: {k} has the "
                                                   "wrong sign")


def split_turns(q, grid, N, dev):
    """K4's split mode against its upper and lower launches at the ERA5
    step, in turns (LWA and LWA2): the device ms of each, their share of
    the bound of every pair at 3 instructions, and whether the halves are
    the single parts' bit for bit (else their relative gap)."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.diagnostics.lwa import nanmax
    from xcontour_tpu_torch.kernels import lwa
    Q = xt.keff_lwa_pipeline(q, grid, N=N)["Q"].contiguous()
    W = (grid.dA / nanmax(grid.dA) * grid.dA).contiguous()
    b_ms = bound_ms(lwa_work(*q.shape))[0]
    out = {}
    for v2 in (False, True):
        kw = dict(increase=True, variant2=v2)

        def split(kw=kw):
            return lwa.lwa_dense(q, Q, W, part="split", **kw)

        def parts(kw=kw):
            return (lwa.lwa_dense(q, Q, W, part="upper", **kw),
                    lwa.lwa_dense(q, Q, W, part="lower", **kw))
        s, p = split(), parts()
        same = all(bool(torch.equal(a, b)) for a, b in zip(s, p))
        rel = max(rel_err(a, b)[1] for a, b in zip(s, p))
        del s, p
        s_ms, p_ms = time_alternating([split, parts], dev, reps=20)
        name = "lwa2" if v2 else "lwa"
        out[name] = dict(split_ms=s_ms, parts_ms=p_ms, bound_ms=b_ms,
                         split_pct=100 * b_ms / s_ms,
                         parts_pct=100 * b_ms / p_ms, bit_for_bit=same,
                         rel=rel)
        log(f"phase 6 kernel K4 split {name} era5 {tuple(q.shape)}: split "
            f"{s_ms:.4f} ms ({100 * b_ms / s_ms:.2f}% of bound "
            f"{b_ms:.4f}), upper + lower {p_ms:.4f} ms "
            f"({100 * b_ms / p_ms:.2f}%), halves "
            f"{'bit for bit' if same else f'rel {rel:.3e}'}")
        _expect(same, f"K4 split {name}: halves differ from the single "
                      f"parts (rel {rel:.3e})")
    log(f"phase 6 K4 split json {json.dumps(out)}")
    return out


def check_lape(out, shape, N, where):
    """The LAPE configuration: lwa_pipeline's checks, and LAPE = -lwa
    positive-definite to the float32 'lin' floor, as examples/ex3 checks."""
    check_lwa_step(out, shape, N, -200.0, 0.0, where)
    lape = -out["lwa"]
    floor = 5e-5 * lape.max()
    _expect(bool(lape.min() >= -floor),
            f"{where}: LAPE min {lape.min().item():.3e} below -{floor.item():.3e}")


def check_keff_pipeline(out, B, N, P, where):
    """keff_pipeline's origin and interp sections."""
    o = out["origin"]
    _shapes(o, {k: (B, N) for k in o if k != "table"}, where)
    _finite(o, ("contour", "intArea", "intgrdS", "Yeq", "Lmin", "table"), where)
    _check_keff(o, where)
    if P is not None:
        _shapes(out["interp"], {k: (B, P) for k in o if k != "table"}, where)


def flat_keff(out):
    """keff_pipeline's sections as one dict, interp keys with ``_at``."""
    flat = dict(out["origin"])
    flat.update({k + "_at": v for k, v in out.get("interp", {}).items()})
    return flat


def card_vs_cpu(label, cpu, gpu, nkeff_mask=NKEFF_MASK, phase=5):
    """Every key of a CPU step against the card's, within CARD_CPU_TOL."""
    worst = []
    for k, want in cpu.items():
        got = gpu[k].cpu()
        base = k[:-3] if k.endswith("_at") else k
        if base == "nkeff":
            got, want = threshold_agree(got, want, CARD_CPU_TOL["nkeff"],
                                        nkeff_mask)
        _, rel = rel_err(got, want)
        tol = CARD_CPU_TOL.get(base, CARD_CPU_TOL_DEFAULT)
        worst.append(f"{k} {rel:.2e}/{tol:g}")
        _expect(rel <= tol, f"card vs CPU {label}: {k} rel {rel:.3e} > {tol:g}")
    log(f"phase {phase} card vs CPU {label}: OK ({', '.join(worst)})")


def timed_steps(fn, steps):
    """Run fn over pre-staged device batches; returns the outputs and the
    per-step wall times (each ends in a synchronize)."""
    outs, times = [], []
    for q in steps:
        t0 = time.perf_counter()
        outs.append(fn(q))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return outs, times


def _bits_equal(got, want, where):
    """Nested output dicts, bit for bit (NaN patterns included)."""
    if isinstance(want, dict):
        _expect(set(got) == set(want), f"{where}: keys differ")
        for k in want:
            _bits_equal(got[k], want[k], f"{where} {k}")
        return
    same = got.shape == want.shape and bool(torch.equal(
        torch.isnan(got), torch.isnan(want))) and bool(torch.equal(
            torch.nan_to_num(got), torch.nan_to_num(want)))
    _expect(same, f"{where}: not bit for bit")


def exact_field(dev, shape, seed):
    """A (B, Ny, Nx) field on a unit Cartesian grid (dA = 1) whose every
    K2 sum is exact, and so the same whatever the order of K2's float
    atomics: even integers along x (a triangle: the centred |dq/dx| is 0
    or 2), the same on every row, a NaN patch on the first field."""
    B, ny, nx = shape
    x = torch.arange(nx, device=dev)
    tri = torch.minimum(x, nx - x)
    q = 2.0 * (tri + 3 * torch.arange(B, device=dev)[:, None, None] + seed)
    q = q.expand(B, ny, nx).to(torch.float32).contiguous()
    q[0, 2:5, 10:20] = float("nan")
    return q


def graph_checks(dev, records, cases):
    """Phase 4: each step cell's entry at its shape through the pipeline's
    CUDA graphs, a fresh cache a cell: a warm-up call, a capture on another
    input, a replay on the first, each bit for bit with the eager body on
    the same input and counting the eager body's launches (none for the
    capture itself).  The fields are :func:`exact_field`'s on a unit grid
    of the cell's shape: K2's float atomics add in no fixed order, so two
    eager runs on the cells' own fields differ in the last bits."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch import pipeline
    kept = pipeline.GRAPHS
    try:
        for label, fn, shape, kw in cases:
            pipeline.GRAPHS = g = pipeline.Graphs()
            grid = xt.from_cartesian(np.arange(shape[1], dtype=np.float64),
                                     np.arange(shape[2], dtype=np.float64),
                                     device=dev)
            if "table" in kw:
                kw = dict(kw, table=xt.cal_area_eqCoord_table_hist(
                    grid.fluid_mask(), grid.ydef, grid.dA,
                    increase=kw.get("increase", True), lt=kw.get("lt", True)))
            q0, q1 = exact_field(dev, shape, 1), exact_field(dev, shape, 2)
            launches = []
            for i, q in enumerate((q0, q1, q0)):
                n0 = [r.launches for r in records]
                got = fn(q, grid, **kw)
                torch.cuda.synchronize()
                n1 = [r.launches for r in records]
                want = fn.__wrapped__(q, grid, **kw)
                torch.cuda.synchronize()
                n2 = [r.launches for r in records]
                call = {r.name: b - a for r, a, b in zip(records, n0, n1)
                        if b > a}
                eager = {r.name: b - a for r, a, b in zip(records, n1, n2)
                         if b > a}
                _expect(call == eager, f"graph {label} call {i}: launches "
                                       f"{call}, eager {eager}")
                _bits_equal(got, want, f"graph {label} call {i}")
                e = call.get("contour_levels", 0)
                _expect(e == int(fn is not xt.local_length_pipeline),
                        f"graph {label} call {i}: {e} contour_levels "
                        "launches")
                launches.append(call)
            _expect((g.captures, g.replays, g.eager) == (1, 2, 1),
                    f"graph {label}: captures {g.captures}, replays "
                    f"{g.replays}, eager {g.eager}")
            log(f"phase 4 graph {label} {shape}: warm-up, capture and "
                f"replay bit for bit with the eager body; launches a call "
                f"{launches[0]} on each; captures 1, replays 2")
            del g, got, want
            pipeline.GRAPHS = kept
            torch.cuda.empty_cache()
    finally:
        pipeline.GRAPHS = kept


def timed_graph_checks(dev, cases):
    """Phase 4: each entry's step at its shape timed by stage (tracing on
    through ``utils.prof.logging``), a fresh cache a cell: the plain
    warm-up, capture and replay, then the timed ones, the timed replay bit
    for bit with the plain one, one stage record a timed call; a timed
    call's stages and the time outside them against a pair of events
    around the call; the event nodes' device cost (the timed graph's
    replays against the plain graph's, in turns) and the host's cost of
    reading a record.  Returns each cell's stage split and costs."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch import pipeline
    from xcontour_tpu_torch.utils import prof

    def replays_ms(graph, n=20):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            graph.graph.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    kept = pipeline.GRAPHS
    res = {}
    try:
        for label, fn, shape, kw in cases:
            pipeline.GRAPHS = g = pipeline.Graphs()
            grid = xt.from_cartesian(np.arange(shape[1], dtype=np.float64),
                                     np.arange(shape[2], dtype=np.float64),
                                     device=dev)
            kw = dict(kw, table=xt.cal_area_eqCoord_table_hist(
                grid.fluid_mask(), grid.ydef, grid.dA, increase=True,
                lt=True))
            q0, q1 = exact_field(dev, shape, 1), exact_field(dev, shape, 2)
            plain = [fn(q, grid, **kw) for q in (q0, q1, q0)]
            n0, lost0 = len(prof.stage_times()), prof.stage_records_lost()
            timed = []
            with prof.logging():
                for q in (q0, q1, q0):
                    timed.append(fn(q, grid, **kw))
                    # finished before the next call reads its record
                    torch.cuda.synchronize()
            recs = prof.stage_times()[n0:]
            for i, (got, want) in enumerate(zip(timed, plain)):
                _bits_equal(got, want, f"timed graph {label} call {i}")
            _expect([r.kind for r in recs] == ["eager", "replay", "replay"]
                    and prof.stage_records_lost() == lost0,
                    f"timed graph {label}: records "
                    f"{[r.kind for r in recs]}")
            graphs = {k[-1]: st for k, (st, _) in g._entries.items()}
            _expect(g.captures == 2 and set(graphs) == {False, True}
                    and graphs[False].stages is None,
                    f"timed graph {label}: no timed and plain graph")
            entry = recs[-1].entry
            sums, around, read_us = [], [], []
            with prof.logging():
                for _ in range(5):
                    a, b = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                    a.record()
                    fn(q0, grid, **kw)
                    b.record()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter_ns()
                    prof.settle(entry)
                    read_us.append((time.perf_counter_ns() - t0) / 1e3)
                    rec = prof.stage_times()[-1]
                    sums.append(sum(ms for _, _, ms in rec.stages)
                                + rec.outside_ms)
                    around.append(a.elapsed_time(b))
            body, pair = statistics.median(sums), statistics.median(around)
            _expect(rec.kind == "replay"
                    and 0.95 * pair <= body <= 1.001 * pair,
                    f"timed graph {label}: stages and outside {body:.4f} "
                    f"ms, the replaying call {pair:.4f} ms")
            turns = [replays_ms(graphs[t]) for t in
                     (False, True, True, False)]
            nodes_us = 1e3 * ((turns[1] + turns[2]) - (turns[0] + turns[3])) \
                / 2
            split = {}
            for n, _, ms in rec.stages:
                split[n] = split.get(n, 0.0) + ms
            split["outside"] = rec.outside_ms
            res[label] = dict(stages_ms=split, body_ms=body,
                              call_ms=pair, event_nodes=2 * len(rec.stages),
                              event_nodes_us=nodes_us,
                              read_record_us=statistics.median(read_us))
            log(f"phase 4 timed graph {label} {shape}: bit for bit with the "
                f"plain replay; records eager, replay, replay; stages and "
                f"outside {body:.4f} ms against {pair:.4f} ms around the "
                f"replaying call; {2 * len(rec.stages)} event nodes "
                f"{nodes_us:.1f} us a replay on the device (plain "
                f"{turns[0]:.4f}, {turns[3]:.4f} ms; timed {turns[1]:.4f}, "
                f"{turns[2]:.4f} ms); reading a record "
                f"{statistics.median(read_us):.1f} us on the host; stage ms "
                + json.dumps({k: round(v, 4) for k, v in split.items()}))
            del g, plain, timed, graphs
            pipeline.GRAPHS = kept
            torch.cuda.empty_cache()
    finally:
        pipeline.GRAPHS = kept
    return res


def lape_data(nt, seed=2):
    """ex3's buoyancy on the MITgcm x-z plane: NaN over rock, a linear EOS."""
    from xcontour_tpu_torch.utils.synth import synth_internalwave
    v, _ = synth_internalwave(nt=nt, nz=LAPE["nz"], nx=LAPE["nx"], seed=seed)
    T = np.where(v["maskC"][None] > 0, v["THETA"], np.nan)
    b = (2e-4 * (T - 20.0) * 9.81).astype(np.float32)
    return v, b


def check_kernel(label, name, kern, plain, shape):
    """One kernel against its plain version; returns the max abs error."""
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    bound = KERNEL_BOUNDS[name]
    ok = rel <= bound
    log(f"phase 3 kernel {name} {label} {shape}: max_abs_err {err:.6g} rel "
        f"{rel:.3e} bound {bound:g} {'OK' if ok else 'FAIL'}")
    _expect(ok, f"{name} disagrees with its plain version")
    return err


def _loss_weights(out, seed):
    """r, seeded numpy normal draws of ``out``'s shape on its device."""
    r = np.random.default_rng(seed).standard_normal(tuple(out.shape))
    return torch.as_tensor(r, dtype=out.dtype, device=out.device)


def checkpointed_dense(q, Q, W, **kw):
    """lwa_dense_plain under autograd with each 16-surface chunk
    checkpointed (torch.utils.checkpoint recomputes its temporaries in the
    backward): the plain version's gradient in the memory of one chunk,
    where holding every chunk's temporaries (K6's shape: 194 chunks) would
    not fit on the card."""
    from torch.utils.checkpoint import checkpoint
    from xcontour_tpu_torch.kernels import lwa

    def rows(a, b, c, js):
        return lwa._dense_rows(lwa._dense_parts(a, b, c), js, **kw)
    return torch.cat([checkpoint(rows, q, Q, W, js, use_reentrant=False)
                      for js in lwa._surface_chunks(q.shape[1])], dim=1)


def function_cases(q, grid, N, tall_q, tall_grid, local, n_lengths=None):
    """name -> (Function call, plain call, wrapper call, inputs) for the
    autograd Function over each of K1-K8: K1-K5 on q with N levels, K7 on
    q with ``n_lengths`` (default N), K6 on tall_q, K8 on q[0] at the
    windows ``local`` and their rolling means.  Each call takes the
    differentiated inputs: q (K1), the two weight channels (K2), q, Q and
    W (K3-K6), data and levels (K7, K8)."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.diagnostics import length as dlength
    from xcontour_tpu_torch.diagnostics import local_length as dlocal
    from xcontour_tpu_torch.diagnostics import lwa as dlwa
    from xcontour_tpu_torch.diagnostics.lwa import nanmax
    from xcontour_tpu_torch.kernels import hist, length, lwa, stencil
    from xcontour_tpu_torch.ops import histogram, stencil as ostencil

    B = q.shape[0]
    dy, dx = ostencil._spacing(grid, q.dtype)
    rdx, rdy = (1.0 / dx).contiguous(), (1.0 / dy).contiguous()
    kw1 = dict(periodic_x=grid.periodic_x, bc_y=grid.bc_y)
    grdS = stencil.squared_gradient_plain(q, rdx, rdy, **kw1)
    ctr = xt.cal_contours(q, N)
    _, edges = histogram._edges(ctr)
    edges = edges.contiguous()
    vf = q.reshape(B, -1).contiguous()
    w1 = torch.broadcast_to(grid.dA, q.shape).reshape(B, -1).contiguous()
    w2 = (grdS * grid.dA).reshape(B, -1).contiguous()
    Q = xt.keff_lwa_pipeline(q, grid, N=N)["Q"].contiguous()
    W = (grid.dA / nanmax(grid.dA) * grid.dA).contiguous()
    tQ = xt.lwa_pipeline(tall_q, tall_grid, N=N)["Q"].contiguous()
    tW = (tall_grid.dA / nanmax(tall_grid.dA) * tall_grid.dA).contiguous()
    yc = torch.deg2rad(grid.ydef).contiguous()
    xc = torch.deg2rad(grid.xdef).contiguous()
    q0 = q[0].contiguous()
    lv = xt.rolling_mean(q0, local["window"], local["stride"])[0].contiguous()
    kw8 = dict(local, latlon=True)

    def lwa_case(method, kern, plain, v2, qq, QQ, WW):
        return (lambda a, b, c: dlwa._LWA.apply(a, b, c, method, True, "all",
                                                v2),
                lambda a, b, c: plain(a, b, c, increase=True),
                lambda a, b, c: kern(a, b, c, increase=True), (qq, QQ, WW))
    dense_v2 = lambda a, b, c, increase: lwa.lwa_dense_plain(
        a, b, c, increase=increase, variant2=True)
    return {
        "squared_gradient": (
            lambda a: ostencil._SquaredGradient.apply(a, rdx, rdy, kw1),
            lambda a: stencil.squared_gradient_plain(a, rdx, rdy, **kw1),
            lambda a: stencil.squared_gradient(a, rdx, rdy, **kw1), (q,)),
        "weighted_cdf": (
            lambda a, b: torch.stack(
                histogram._WeightedCDF.apply(vf, edges, a, b), dim=1),
            lambda a, b: hist.weighted_cdf_plain(vf, edges,
                                                 torch.stack([a, b], 1)),
            lambda a, b: hist.weighted_cdf(vf, edges, torch.stack([a, b], 1)),
            (w1, w2)),
        "lwa_lin": lwa_case("lin", lwa.lwa_lin, lwa.lwa_lin_plain, False,
                            q, Q, W),
        "lwa_dense": lwa_case("dense", lwa.lwa_dense, lwa.lwa_dense_plain,
                              False, q, Q, W),
        "lwa_dense_v2": lwa_case(
            "dense", lambda a, b, c, increase: lwa.lwa_dense(
                a, b, c, increase=increase, variant2=True), dense_v2, True,
            q, Q, W),
        "lwa_lin2": lwa_case("lin", lwa.lwa_lin2, lwa.lwa_lin2_plain, True,
                             q, Q, W),
        "lwa_dense_tall": lwa_case(
            "dense", lwa.lwa_dense,
            lambda a, b, c, increase: checkpointed_dense(
                a, b, c, increase=increase, part="all", variant2=False),
            False, tall_q, tQ, tW),
        "contour_lengths": (
            lambda a, b: dlength._ContourLengths.apply(a, b, yc, xc, True, 8),
            lambda a, b: length.contour_lengths_plain(a, b, yc, xc,
                                                      latlon=True),
            lambda a, b: length.contour_lengths(a, b, yc, xc, latlon=True),
            (q, xt.cal_contours(q, n_lengths or N).contiguous())),
        "local_lengths": (
            lambda a, b: dlocal._LocalLengths.apply(a, b, yc, xc, kw8),
            lambda a, b: length.local_lengths_plain(a, b, yc, xc, **kw8),
            lambda a, b: length.local_lengths(a, b, yc, xc, **kw8), (q0, lv)),
    }


def _leaves(inputs):
    return [x.detach().clone().requires_grad_() for x in inputs]


def grad_err(got, want, where):
    """Largest |got - want| over the largest |want|; the non-finite
    patterns must agree."""
    _expect(torch.equal(torch.isfinite(got), torch.isfinite(want))
            and torch.equal(torch.isnan(got), torch.isnan(want)),
            f"{where}: non-finite patterns differ")
    m = torch.isfinite(want)
    scale = want[m].double().abs().max().item() if m.any() else 0.0
    err = (got[m].double() - want[m].double()).abs().max().item() \
        if m.any() else 0.0
    return err / scale if scale > 0 else err, scale


def check_function(name, fn, plain, wrapper, inputs, seed):
    """One Function on the card: its forward against the wrapper's on the
    same inputs (bit for bit, but K2, whose float atomics add in any order:
    within its kernel bound), and its gradients of sum(r * out) against
    torch.autograd.grad through the plain version (the same non-finite
    pattern, within GRAD_BOUND of the largest |gradient|).  Returns the
    worst relative error."""
    xs = _leaves(inputs)
    out = fn(*xs)
    ref = wrapper(*(x.detach() for x in xs))
    torch.cuda.synchronize()
    same = torch.equal(out.detach().view(torch.int32), ref.view(torch.int32))
    if name == "weighted_cdf":
        _, rel = rel_err(out.detach(), ref)
        _expect(rel <= KERNEL_BOUNDS[name],
                f"{name}: the Function's forward differs from the wrapper's")
    else:
        _expect(same, f"{name}: the Function's forward differs from the "
                      "wrapper's bits")
    r = _loss_weights(out, seed)
    got = torch.autograd.grad(torch.nansum(out * r), xs)
    ys = _leaves(inputs)
    want = torch.autograd.grad(torch.nansum(plain(*ys) * r), ys)
    torch.cuda.synchronize()
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        rel, scale = grad_err(g, w, f"{name} input {i}")
        _expect(scale > 0, f"{name} input {i}: zero gradient")
        worst = max(worst, rel)
    ok = worst <= GRAD_BOUND
    log(f"phase 7 function {name} {tuple(inputs[0].shape)}: forward "
        f"{'bit for bit' if same else 'within bound'} of the wrapper; "
        f"gradients against plain autograd rel {worst:.3e} bound "
        f"{GRAD_BOUND:g} {'OK' if ok else 'FAIL'}")
    _expect(ok, f"{name}: gradient differs from plain autograd")
    return worst


def time_backward(name, fn, inputs, seed, reps=3):
    """(forward ms, backward ms, backward's peak GiB above what it starts
    with) of one Function by CUDA events, the graph kept between the
    backward runs."""
    xs = _leaves(inputs)
    fwd = cuda_ms(lambda: fn(*xs), reps)
    out = fn(*xs)
    loss = torch.nansum(out * _loss_weights(out, seed))
    run = lambda: torch.autograd.grad(loss, xs, retain_graph=True)
    run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bwd = cuda_ms(run, reps)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f"phase 7 time function {name} {tuple(inputs[0].shape)}: forward "
        f"{fwd:.4f} ms, backward {bwd:.4f} ms, backward peak {peak:.3f} GiB")
    return fwd, bwd, peak


def finite_sum(x):
    return torch.nansum(torch.where(torch.isfinite(x), x,
                                    torch.zeros_like(x)))


def grad_losses(grid, table, local_window):
    """label -> loss of a (B, Ny, Nx) tracer: the JAX bench's adjoint loss
    nansum(lwa^2) + nansum(nkeff) of keff_lwa_pipeline(lmin='analytic'),
    'auto' (K1, K2, K3) and 'dense' (K4), with_lwa2 (+ nansum(lwa2^2),
    K5); clength_pipeline N = CLENGTH_N[0] (nansum of the lengths and of
    the finite Leq2; K2, K7); local_contour_lengths at ``local_window`` on
    each snapshot (nansum of the lengths; K8)."""
    import xcontour_tpu_torch as xt

    def keff_lwa(method, lwa2=False):
        def loss(t, N):
            o = xt.keff_lwa_pipeline(t, grid, N=N, lmin="analytic",
                                     lwa_method=method, with_lwa2=lwa2,
                                     table=table)
            out = torch.nansum(o["lwa"] * o["lwa"]) + torch.nansum(o["nkeff"])
            return out + torch.nansum(o["lwa2"] * o["lwa2"]) if lwa2 else out
        return loss

    def clength(t, N):
        o = xt.clength_pipeline(t, grid, N=CLENGTH_N[0], table=table)
        return torch.nansum(o["lengths"]) + finite_sum(o["Leq2"])

    def local(t, N):
        return sum(torch.nansum(xt.local_contour_lengths(
            t[k], grid.ydef, grid.xdef, **local_window)[0])
            for k in range(t.shape[0]))
    return {"keff_lwa auto": (keff_lwa("auto"), ("squared_gradient",
                                                 "weighted_cdf", "lwa_lin",
                                                 "contour_levels")),
            "keff_lwa dense": (keff_lwa("dense"), ("squared_gradient",
                                                   "weighted_cdf",
                                                   "lwa_dense",
                                                   "contour_levels")),
            "keff_lwa with_lwa2": (keff_lwa("auto", True),
                                   ("lwa_lin", "lwa_lin2", "contour_levels")),
            "clength": (clength, ("weighted_cdf", "contour_lengths",
                                  "contour_levels")),
            "local": (local, ("local_lengths",))}


def near_nan(q, cells=2):
    """Cells within ``cells`` rows or columns of a NaN cell of q."""
    m = torch.isnan(q).float()[:, None]
    k = 2 * cells + 1
    return torch.nn.functional.max_pool2d(m, k, 1, cells)[:, 0] > 0


def adjoint_ms(loss, q, N):
    """(forward ms, backward ms, gradient) of one step of ``loss`` on a
    copy of q, by the host clock between synchronizations (phase 7's
    adjoint steps, phase 11's sharded ones)."""
    t = q.detach().clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = loss(t, N)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g, = torch.autograd.grad(value, t)
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3, g


def kernel_records():
    """K1-K8's, the archive decode's, box counting's, the window means',
    the contour-length weights' and the contour levels' launch records."""
    from xcontour_tpu_torch.kernels import (boxcount, decode, extrema, gradw,
                                            hist, length, lwa, rolling,
                                            stencil)
    return (stencil.KERNEL, hist.KERNEL, lwa.KERNEL_LIN, lwa.KERNEL_DENSE,
            lwa.KERNEL_LIN2, lwa.KERNEL_DENSE_TALL, length.KERNEL_LENGTHS,
            length.KERNEL_LOCAL_LENGTHS, decode.KERNEL, boxcount.KERNEL,
            rolling.KERNEL, gradw.KERNEL, extrema.KERNEL)


def kernel_counts():
    return {r.name: r.launches for r in kernel_records()}


def adjoint_step(label, loss, kernels, q, N, records, reps=3):
    """forward + backward steps of ``loss`` on q: (median forward ms,
    median backward ms, peak GiB, launches a step, gradient).  The launch
    counts of a gradient step must equal a no-grad step's, the gradient
    must be nonzero and its non-finite cells lie within two rows or
    columns of q's NaN cells."""
    def counts():
        return {r.name: r.launches for r in records}
    for r in records:
        r.launches = 0
    with torch.no_grad():
        loss(q, N)
    torch.cuda.synchronize()
    plain_counts = counts()
    fwd, bwd = [], []
    for i in range(reps + 1):
        for r in records:
            r.launches = 0
        torch.cuda.reset_peak_memory_stats()
        f, b, g = adjoint_ms(loss, q, N)
        if i:                                   # the first is a warm-up
            fwd.append(f)
            bwd.append(b)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step = counts()
    _expect(step == plain_counts, f"{label}: a gradient step launches "
            f"{step}, a no-grad step {plain_counts}")
    short = [k for k in kernels if step[k] == 0]
    _expect(not short, f"{label}: kernels not launched: {short}")
    finite = torch.isfinite(g)
    gmax = g[finite].abs().max().item() if finite.any() else 0.0
    _expect(gmax > 0, f"{label}: zero gradient")
    stray = int((~finite & ~near_nan(q)).sum())
    _expect(stray == 0, f"{label}: {stray} non-finite gradient cells more "
            "than two cells from a NaN cell")
    f_ms, b_ms = statistics.median(fwd), statistics.median(bwd)
    log(f"phase 7 adjoint {label} {tuple(q.shape)}: forward {f_ms:.2f} ms, "
        f"backward {b_ms:.2f} ms (steps {[round(x, 2) for x in bwd]}), "
        f"{q.shape[0] * 1e3 / (f_ms + b_ms):.1f} gradient-snapshots/s, peak "
        f"{peak:.3f} GiB, launches a step {step}, non-finite gradient cells "
        f"{int((~finite).sum())} (all within 2 of a NaN cell), max |g| "
        f"{gmax:.6g}")
    return f_ms, b_ms, peak, step, g


def grad_agree(what, got, want, sides=("card", "CPU")):
    """A gradient against another of the same loss: the same non-finite
    pattern, and GRAD_CARD_CPU[1] of the finite cells within
    GRAD_CARD_CPU[0] of the largest |gradient|; the worst cell printed.
    Returns (share within, worst difference over max |g|)."""
    got, want = got.detach().cpu(), want.detach().cpu()
    _expect(torch.equal(torch.isfinite(got), torch.isfinite(want)),
            f"{what}: non-finite patterns differ")
    m = torch.isfinite(want)
    scale = want[m].abs().max().item()
    diff = torch.where(m, (got - want).abs(), torch.zeros_like(got))
    tol, share_min = GRAD_CARD_CPU
    share = (diff[m] <= tol * scale).double().mean().item()
    worst = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    ok = share >= share_min and scale > 0
    log(f"{what} {tuple(got.shape)}: {100 * share:.4f}% "
        f"of cells within {tol:g} of max |g| {scale:.6g} (need "
        f"{100 * share_min:g}%), worst cell {tuple(int(i) for i in worst)} "
        f"diff {diff[worst].item() / scale:.3e} of max ({sides[0]} "
        f"{got[worst].item():.6g}, {sides[1]} {want[worst].item():.6g}); "
        f"non-finite cells {int((~m).sum())} on both "
        f"{'OK' if ok else 'FAIL'}")
    _expect(ok, f"{what}: gradients differ")
    return share, diff[worst].item() / scale


def grad_card_vs_cpu(label, loss_gpu, loss_cpu, q, N):
    """A loss's gradient on the card (float32) against the port's CPU
    float32 gradient (:func:`grad_agree`)."""
    grads = []
    for loss, dev in ((loss_gpu, q.device), (loss_cpu, "cpu")):
        t = q.detach().to(dev).clone().requires_grad_()
        grads.append(torch.autograd.grad(loss(t, N), t)[0].cpu())
    grad_agree(f"phase 7 grad card vs CPU {label}", *grads)


def wrapper_grad_limits(dev):
    """Every kernel wrapper, called directly on a CUDA tensor that
    requires grad, raises: wrappers record no graph."""
    from xcontour_tpu_torch.kernels import (boxcount, hist, length, lwa,
                                            rolling, stencil)
    T = lambda *s: torch.rand(*s, device=dev)
    q, W, Q = T(2, 8, 16), T(8, 16), T(2, 8)
    lev, yc, xc = T(2, 3), T(8), T(16)
    calls = {
        "squared_gradient": lambda a: stencil.squared_gradient(
            a, T(8, 16), T(8), periodic_x=True),
        "weighted_cdf": lambda a: hist.weighted_cdf(
            a.reshape(2, -1), torch.sort(T(2, 4), -1).values,
            T(2, 1, 128)),
        "lwa_lin": lambda a: lwa.lwa_lin(a, Q, W, increase=True),
        "lwa_lin2": lambda a: lwa.lwa_lin2(a, Q, W, increase=True),
        "lwa_dense": lambda a: lwa.lwa_dense(a, Q, W, increase=True),
        "contour_lengths": lambda a: length.contour_lengths(
            a, lev, yc, xc, latlon=True),
        "local_lengths": lambda a: length.local_lengths(
            a[0], T(2, 4), yc, xc, window=4, stride=4, latlon=True),
        "box_counts": lambda a: boxcount.box_counts(a, lev, T(8, 16),
                                                    [1, 2]),
        "window_means": lambda a: rolling.window_means(a, 4, 4)}
    for name, call in calls.items():
        try:
            call(q.clone().requires_grad_())
        except RuntimeError as e:
            _expect("records no graph" in str(e), f"{name}: {e}")
        else:
            raise AssertionError(f"{name}: a direct call on a tensor that "
                                 "requires grad did not raise")
    log(f"phase 7 limits: each of {len(calls)} wrappers raises on a CUDA "
        "tensor that requires grad")


def grad_phase(dev, records, era_q, era_grid, era_table, head_q, head_grid,
               head_table):
    """Phase 7: the autograd Functions on the card.  Returns {name: (forward
    ms, backward ms, backward peak GiB)} of each Function at its path's
    shape, and {label: (forward ms, backward ms, peak GiB, launches)} of
    each adjoint step."""
    import xcontour_tpu_torch as xt
    wrapper_grad_limits(dev)

    # each Function against plain autograd at the check shapes
    g = GRAD_CHECK
    lat, lon, pv = make_pv(g["B"], g["nlat"], g["nlon"], 21)
    grid = xt.from_latlon(lat, lon, device=dev)
    tlat, tlon, tpv = make_pv(*GRAD_TALL, 22)
    tgrid = xt.from_latlon(tlat, tlon, device=dev)
    q, tq = torch.as_tensor(pv).to(dev), torch.as_tensor(tpv).to(dev)
    cases = function_cases(q, grid, g["N"], tq, tgrid, GRAD_LOCAL)
    for i, (name, (fn, plain, wrapper, inputs)) in enumerate(cases.items()):
        check_function(name, fn, plain, wrapper, inputs, 300 + i)
    del cases

    # each Function's forward and backward at its path's shape: ERA5 B =
    # GRAD_ERA5_B (K8 on one level at LOCAL), K6 on the tall grid
    B = GRAD_ERA5_B
    tall_lat, tall_lon, tall_pv = make_pv(TALL["B"], TALL["nlat"],
                                          TALL["nlon"], 200)
    tall_grid = xt.from_latlon(tall_lat, tall_lon, device=dev)
    cases = function_cases(era_q[:B].contiguous(), era_grid, ERA5["N"],
                           torch.as_tensor(tall_pv).to(dev), tall_grid, LOCAL,
                           n_lengths=CLENGTH_N[0])
    times = {}
    for i, (name, (fn, _, _, inputs)) in enumerate(cases.items()):
        times[name] = time_backward(name, fn, inputs, 400 + i)
    del cases

    # the adjoint steps at the JAX bench's shapes
    steps = {}
    head = grad_losses(head_grid, head_table, LOCAL)["keff_lwa auto"]
    steps["keff_lwa auto headline"] = adjoint_step(
        "keff_lwa auto headline", head[0], head[1], head_q, HEADLINE["N"],
        records)[:4]
    q = era_q[:B].contiguous()
    for label, (loss, kernels) in grad_losses(era_grid, era_table,
                                              LOCAL).items():
        key = f"{label} era5"
        steps[key] = adjoint_step(key, loss, kernels, q, ERA5["N"],
                                  records)[:4]

    # card against CPU on a small step of each loss
    s = GRAD_SMALL
    slat, slon, spv = make_pv(s["B"], s["nlat"], s["nlon"], 23)
    cgrid = xt.from_latlon(slat, slon, device="cpu")
    ggrid = xt.from_latlon(slat, slon, device=dev)
    ctab = xt.cal_area_eqCoord_table_hist(cgrid.fluid_mask(), cgrid.ydef,
                                          cgrid.dA, increase=True, lt=True)
    gtab = xt.cal_area_eqCoord_table_hist(ggrid.fluid_mask(), ggrid.ydef,
                                          ggrid.dA, increase=True, lt=True)
    gl = grad_losses(ggrid, gtab, GRAD_LOCAL)
    cl = grad_losses(cgrid, ctab, GRAD_LOCAL)
    sq = torch.as_tensor(spv).to(dev)
    for label in gl:
        grad_card_vs_cpu(label, gl[label][0], cl[label][0], sq, s["N"])
    return times, steps


def measure(fn, reps=LADDER_REPS):
    """(median ms of ``reps`` calls, each between CUDA events, after one
    warm-up; peak device GiB above what was allocated before)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    return statistics.median(times), peak


def exact_checks(dev, drive, q, grid, table):
    """The exact engine on the ERA5 step: the exact integral against the
    broadcast one (both lt), cal_contours_at with each method (K2 only for
    'hist'), timed with their peak memory; card against CPU at 2x256x512.
    Returns {label: (ms, peak GiB)}."""
    import xcontour_tpu_torch as xt
    none = dict(weighted_cdf=0, lwa_lin=0, lwa_lin2=0, lwa_dense=0,
                lwa_dense_tall=0)
    dA = grid.dA
    ctr = xt.cal_contours(q, ERA5["N"])
    timing = {}
    for lt in (True, False):
        def run(lt=lt):
            return xt.cal_integral_within_contours_exact(q, ctr, dA, lt=lt)
        got = drive(f"exact integral era5 lt={lt}", {}, run, exact=none)
        want = xt.cal_integral_within_contours(q, ctr, dA, lt=lt)
        err, rel = rel_err(got, want)
        log(f"phase 8 exact integral era5 lt={lt} {tuple(got.shape)} against "
            f"broadcast: max_abs_err {err:.6g} rel {rel:.3e} bound "
            f"{EXACT_BOUND:g} {'OK' if rel <= EXACT_BOUND else 'FAIL'}")
        _expect(rel <= EXACT_BOUND, "exact integral disagrees with broadcast")
        timing[f"integral exact lt={lt}"] = measure(run)
        timing[f"integral broadcast lt={lt}"] = measure(
            lambda lt=lt: xt.cal_integral_within_contours(q, ctr, dA, lt=lt),
            reps=3)
    predef = torch.linspace(*EXACT_PREDEF, device=dev)
    levels = {}
    for method in ("exact", "broadcast", "hist"):
        k2 = int(method == "hist")

        def run(method=method):
            return xt.cal_contours_at(predef, table, q, dA, increase=True,
                                      lt=True, method=method)
        levels[method] = drive(f"contours_at era5 {method}",
                               {"weighted_cdf": k2}, run,
                               exact=dict(none, weighted_cdf=k2))
        _shapes({"levels": levels[method]},
                {"levels": (q.shape[0], EXACT_PREDEF[2])},
                f"contours_at era5 {method}")
        _finite({"levels": levels[method]}, ["levels"],
                f"contours_at era5 {method}")
        timing[f"contours_at {method}"] = measure(
            run, reps=3 if method == "broadcast" else LADDER_REPS)
    # what cal_contours_at adds to its integral: the levels, the table
    # lookup and the interpolation onto predef
    rough = xt.cal_contours(q, EXACT_PREDEF[2])
    area = xt.cal_integral_within_contours_exact(q, rough, dA, lt=True)
    timing["contours_at without its integral"] = measure(
        lambda: xt.interp_to_coords(predef, table.lookup_coordinates(area),
                                    xt.cal_contours(q, EXACT_PREDEF[2])))
    _, rel = rel_err(levels["exact"], levels["broadcast"])
    _, rel_h = rel_err(levels["exact"], levels["hist"])
    log(f"phase 8 contours_at era5 exact against broadcast: rel {rel:.3e} "
        f"bound {LEVELS_BOUND:g} {'OK' if rel <= LEVELS_BOUND else 'FAIL'}; "
        f"against hist: rel {rel_h:.3e}")
    _expect(rel <= LEVELS_BOUND, "contours_at exact disagrees with broadcast")
    for label, (ms, gib) in timing.items():
        log(f"phase 8 time {label} era5: {ms:.4f} ms, peak {gib:.3f} GiB "
            f"above its inputs")

    # card against CPU on a small step
    slat, slon, spv = make_pv(2, 256, 512, 7)
    out = {}
    for d in ("cpu", dev):
        g = xt.from_latlon(slat, slon, device=d)
        sq = torch.as_tensor(spv).to(d)
        tbl = xt.cal_area_eqCoord_table_hist(g.fluid_mask(), g.ydef, g.dA,
                                             increase=True, lt=True)
        c = xt.cal_contours(sq, 121)
        out[str(d)] = dict(
            intArea=xt.cal_integral_within_contours_exact(sq, c, g.dA,
                                                          lt=True),
            levels=xt.cal_contours_at(
                torch.linspace(-80.0, 80.0, 33, device=d), tbl, sq, g.dA,
                increase=True, lt=True))
    card_vs_cpu("exact integral and contours_at 2x256x512", out["cpu"],
                out[str(dev)], phase=8)
    return timing, levels


def fast_checks(dev, drive, era_q, era_grid, era_table, tall_q, tall_grid):
    """'fast' through the pipelines against 'dense' on the card: the tall
    grid's lwa_pipeline (K6) and the ERA5 keff_lwa_pipeline with LWA2 (K4),
    no LWA kernel launched on the 'fast' side; NaN profile rows give exact
    zero rows."""
    import xcontour_tpu_torch as xt
    none = dict(lwa_lin=0, lwa_lin2=0, lwa_dense=0, lwa_dense_tall=0)

    def compare(label, fast, dense, keys):
        for key in keys:
            err, rel = rel_err(fast[key], dense[key])
            log(f"phase 8 fast {label} {key} against dense: max_abs_err "
                f"{err:.6g} rel {rel:.3e} bound {FAST_BOUND:g} "
                f"{'OK' if rel <= FAST_BOUND else 'FAIL'}")
            _expect(rel <= FAST_BOUND, f"fast {label} {key} disagrees")

    # an own-table step: K2 for the table and for the step
    fast = drive("lwa tall fast", {"weighted_cdf": 2},
                 lambda: xt.lwa_pipeline(tall_q, tall_grid, N=TALL["N"],
                                         lwa_method="fast"),
                 exact=dict(none, weighted_cdf=2))
    check_lwa_step(fast, tuple(tall_q.shape), TALL["N"], -90.0, 90.0,
                   "lwa tall fast")
    dense = drive("lwa tall dense (K6, reference)", {"lwa_dense_tall": 2},
                  lambda: xt.lwa_pipeline(tall_q, tall_grid, N=TALL["N"],
                                          lwa_method="dense"))
    compare("tall", fast, dense, ("lwa", "lwa2"))

    kw = dict(N=ERA5["N"], with_lwa2=True, table=era_table)
    fast = drive("keff_lwa era5 fast with_lwa2",
                 {"squared_gradient": 1, "weighted_cdf": 1},
                 lambda: xt.keff_lwa_pipeline(era_q, era_grid,
                                              lwa_method="fast", **kw),
                 exact=dict(none, squared_gradient=1, weighted_cdf=1))
    check_step(fast, ERA5["B"], ERA5["nlat"], ERA5["N"],
               "keff_lwa era5 fast with_lwa2")
    dense = drive("keff_lwa era5 dense with_lwa2 (K4, reference)",
                  {"lwa_dense": 2},
                  lambda: xt.keff_lwa_pipeline(era_q, era_grid,
                                               lwa_method="dense", **kw))
    compare("era5", fast, dense, ("lwa", "lwa2"))

    Q = fast["Q"].clone()
    rows = [0, ERA5["nlat"] // 2]
    Q[:, rows] = float("nan")
    args = (era_q, Q, era_grid.dA, era_grid.ydef)
    nan_rows = {m: xt.local_wave_activity(*args, increase=True, method=m)
                for m in ("fast", "dense")}
    for m, out in nan_rows.items():
        _expect(bool((out[:, rows] == 0).all()),
                f"{m}: NaN profile rows are not exactly zero")
    compare("era5 NaN profile rows", {"lwa": nan_rows["fast"]},
            {"lwa": nan_rows["dense"]}, ("lwa",))
    log(f"phase 8 fast era5 NaN profile rows {rows}: exact zeros in 'fast' "
        f"and 'dense'")


def ladder(dev, era_q, era_Q, era_grid):
    """'lin' (K3, K5) against 'fast' through local_wave_activity[2] at
    LADDER_B x Ny x LADDER_NX and the ERA5 step; returns the rows and, for
    each variant and for the two together (lwa_pipeline runs both), the
    smallest Ny of the ladder from which 'fast' is faster at every taller
    Ny (None if it never is)."""
    import xcontour_tpu_torch as xt
    rows = []
    shapes = [(LADDER_B, ny, LADDER_NX) for ny in LADDER_NYS]
    for i, shape in enumerate(shapes + [tuple(era_q.shape)]):
        if i < len(shapes):
            lat, lon, pv = make_pv(*shape, 300 + i)
            grid = xt.from_latlon(lat, lon, device=dev)
            q = torch.as_tensor(pv).to(dev)
            Q = xt.lwa_pipeline(q, grid, N=ERA5["N"],
                                lwa_method="lin")["Q"].contiguous()
        else:
            q, Q, grid = era_q, era_Q, era_grid
        row = dict(shape=list(shape))
        for tag, fn in (("lwa", xt.local_wave_activity),
                        ("lwa2", xt.local_wave_activity2)):
            outs = {}
            for m in ("lin", "fast"):
                def call(m=m, fn=fn):
                    return fn(q, Q, grid.dA, grid.ydef, increase=True,
                              method=m)
                outs[m] = call()
                row[f"{tag}_{m}_ms"], row[f"{tag}_{m}_gib"] = measure(call)
            _, row[f"{tag}_fast_vs_lin"] = rel_err(outs["fast"], outs["lin"])
        log(f"phase 8 ladder {'x'.join(map(str, shape))}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in row.items() if k != "shape"))
        rows.append(row)
    cross = {}
    for tag, tags in (("lwa", ("lwa",)), ("lwa2", ("lwa2",)),
                      ("both", ("lwa", "lwa2"))):
        wins = [sum(r[f"{t}_fast_ms"] for t in tags)
                < sum(r[f"{t}_lin_ms"] for t in tags)
                for r in rows[:len(shapes)]]
        first = [LADDER_NYS[k] for k in range(len(wins)) if all(wins[k:])]
        cross[tag] = first[0] if first else None
    return rows, cross


def auto_checks(dev, drive):
    """'auto' just below and at the port's crossover: K3 and K5 launch once
    each below it and not at all at it (part='all', both variants)."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.diagnostics import lwa as tlwa
    c = tlwa._FAST_NY_CROSSOVER
    for ny, n in ((c - 1, 1), (c, 0)):
        lat, lon, pv = make_pv(2, ny, LADDER_NX, 500)
        grid = xt.from_latlon(lat, lon, device=dev)
        q = torch.as_tensor(pv).to(dev)
        lo = torch.nan_to_num(q, nan=float("inf")).amin((-2, -1))
        hi = torch.nan_to_num(q, nan=float("-inf")).amax((-2, -1))
        ramp = torch.linspace(0.0, 1.0, ny, device=q.device)
        Q = lo[:, None] + (hi - lo)[:, None] * ramp[None]
        args = (q, Q, grid.dA, grid.ydef)
        drive(f"auto Ny={ny} (crossover {c})", {"lwa_lin": n, "lwa_lin2": n},
              lambda: (xt.local_wave_activity(*args, increase=True),
                       xt.local_wave_activity2(*args, increase=True)),
              exact=dict(lwa_lin=n, lwa_lin2=n, lwa_dense=0,
                         lwa_dense_tall=0, weighted_cdf=0))
        log(f"phase 8 auto at Ny={ny}: {'lin' if n else 'fast'} (K3, K5 "
            f"launched {n} time{'s' if n != 1 else ''} each)")


def facade_vs(label, got, want, keys, what="phase 9 facade",
              against="the pipeline"):
    """The facade's outputs against the pipeline's on the same CUDA tensors
    (module constants: FACADE_BOUND, CARD_CPU_TOL for amplified keys,
    EXTREME_AREA for nkeff); ``what`` heads the log line."""
    A = want["intArea"]
    top = A.amax(-1, keepdim=True)
    ill = torch.minimum(A, top - A) < EXTREME_AREA * top
    worst = [f"{int(ill.sum())} extreme contours of {A.numel()}"]
    for k in keys:
        g, w = got[k], want[k]
        if k in CARD_CPU_TOL:
            nan = torch.full_like(g, float("nan"))
            g, w = torch.where(ill, nan, g), torch.where(ill, nan, w)
        if k == "nkeff":
            g, w = threshold_agree(g, w, CARD_CPU_TOL["nkeff"])
        _, rel = rel_err(g, w)
        tol = CARD_CPU_TOL.get(k, FACADE_BOUND)
        worst.append(f"{k} {rel:.2e}/{tol:g}")
        _expect(rel <= tol, f"{label}: {k} rel {rel:.3e} > {tol:g}")
    log(f"{what} {label} against {against}: OK ({', '.join(worst)})")


def field_rel(label, got, want, bound=FACADE_BOUND, what="phase 9"):
    """A field against another, relative to the other's maximum."""
    err, rel = rel_err(got, want)
    log(f"{what} {label}: max_abs_err {err:.6g} rel {rel:.3e} bound "
        f"{bound:g} {'OK' if rel <= bound else 'FAIL'}")
    _expect(rel <= bound, f"{label} disagrees")
    return rel


def keff_chain(an, grid, table, N):
    """The reference's notebook 1 on a Contour2D: levels, the area and
    |grad q|^2 integrals by histogram, their d/dA, Leq^2, Lmin at the
    equivalent latitudes, normalized Keff (one K1 launch, two K2)."""
    import xcontour_tpu_torch as xt
    ctr = an.cal_contours(N)
    grdS = xt.squared_gradient(an.tracer, grid)
    area = an.cal_integral_within_contours_hist(ctr)
    intS = an.cal_integral_within_contours_hist(ctr, integrand=grdS)
    Yeq = table.lookup_coordinates(area)
    dqdA = an.cal_gradient_wrt_area(ctr, area)
    dgdA = an.cal_gradient_wrt_area(intS, area)
    Leq2 = an.cal_sqared_equivalent_length(dgdA, dqdA)
    Lmin = xt.latitude_lengths_at(Yeq)
    return dict(contour=ctr, intArea=area, intgrdS=intS, Yeq=Yeq,
                dgrdSdA=dgdA, dqdA=dqdA, Leq2=Leq2, Lmin=Lmin,
                nkeff=an.cal_normalized_Keff(Leq2, Lmin, NKEFF_MASK))


def lwa_profile(an, table, N):
    """The sorted profile Q of notebook 2: levels, areas (K2), equivalent
    latitudes, Q interpolated onto the grid's latitudes."""
    ctr = an.cal_contours(N)
    latEq = table.lookup_coordinates(an.cal_integral_within_contours_hist(ctr))
    return an.interp_to_coords(an.grid.ydef, latEq, ctr)


def mask_checks(q, Q, masks, W):
    """Each mask of mask_idx against an independent statement of the
    reference's rule (+1 where q < Q_j on or poleward of y_j, -1 where
    q > Q_j equatorward of it, else 0; an ascending coordinate), and the
    surface rebuilt from it, -sum_y mask (q - Q_j) W, against K4's row j on
    the same inputs within K4's bound."""
    from xcontour_tpu_torch.kernels import lwa as kl
    iy = torch.arange(q.shape[-2], device=q.device)
    dense = kl.lwa_dense(q.contiguous(), Q.contiguous(), W.contiguous(),
                         increase=True)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    worst = 0.0
    for mask, j in zip(masks, MASK_IDX):
        qe = q - Q[:, j, None, None]
        north = (iy >= j)[:, None]
        want = torch.where(north & (qe < 0), 1.0,
                           torch.where(~north & (qe > 0), -1.0, 0.0))
        _expect(torch.equal(mask, want.to(mask.dtype)),
                f"mask at surface {j} differs from the reference's rule")
        row = -(torch.where(torch.isnan(qe), zero, qe) * mask * W).sum(-2)
        _, rel = rel_err(row, dense[:, j])
        worst = max(worst, rel)
    bound = KERNEL_BOUNDS["lwa_dense"]
    log(f"phase 9 masks {MASK_IDX}: equal to the rule at every (b, y, x); "
        f"rows rebuilt from them against K4 rel {worst:.3e} bound {bound:g} "
        f"{'OK' if worst <= bound else 'FAIL'}")
    _expect(worst <= bound, "rows rebuilt from the masks disagree with K4")


def host_k7_checks(q, grid, ctr):
    """K7 on one ERA5 level against the host traversal (native marching
    squares, float64): at two interior levels, the sum of contour_length
    over every piece find_contour extracts (neither wraps x) against K7's
    total."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.host import native
    _expect(native._load() is not None,
            "the native marching-squares library did not build or load")
    lat = grid.ydef.cpu().numpy()
    lon = grid.xdef.cpu().numpy()
    field = q.cpu().numpy()
    bound = KERNEL_BOUNDS["contour_lengths"]
    out = []
    for c in (ctr[ctr.shape[0] // 3], ctr[2 * ctr.shape[0] // 3]):
        t0 = time.perf_counter()
        segs = xt.xcontour.find_contour(field, (lat, lon), float(c))
        host = sum(xt.contour_length(s, latlon=True) for s in segs)
        host_s = time.perf_counter() - t0
        k7 = xt.contour_lengths(q[None], c.reshape(1, 1), grid.ydef,
                                grid.xdef, latlon=True)[0, 0].item()
        rel = abs(k7 - host) / host
        out.append(rel)
        log(f"phase 9 K7 against the host traversal at level {float(c):.6g}: "
            f"{len(segs)} pieces, host {host:.9g} m in {1e3 * host_s:.1f} ms, "
            f"K7 {k7:.9g} m, rel {rel:.3e} bound {bound:g} "
            f"{'OK' if rel <= bound else 'FAIL'}")
        _expect(rel <= bound, "K7 disagrees with the host traversal")
    return out


def dataset_round_trip(label, ds, tmp):
    """Write ``ds`` with to_nc3, read it back: values, dims and coordinates
    as written.  Returns (write ms, read ms, MB)."""
    from xcontour_tpu_torch.utils.ncio import load_dataset
    path = f"{tmp}/{label}.nc"
    t0 = time.perf_counter()
    ds.to_nc3(path)
    t1 = time.perf_counter()
    back = load_dataset(path)
    t2 = time.perf_counter()
    for k, v in ds.variables.items():
        _expect(np.array_equal(back[k], v, equal_nan=True),
                f"{label}: {k} changed through nc3")
        _expect(tuple(back.dims_of(k)) == tuple(ds.dims_of(k)),
                f"{label}: dims of {k} {back.dims_of(k)} != {ds.dims_of(k)}")
    for k, v in ds.coords.items():
        _expect(np.array_equal(np.asarray(back[k]), v),
                f"{label}: coordinate {k} changed through nc3")
    mb = sum(v.nbytes for v in ds.variables.values()) / 2 ** 20
    return 1e3 * (t1 - t0), 1e3 * (t2 - t1), mb


def facade_small_oracle(dev):
    """Contour2D on the card against the float64 oracle (compat) on the host
    at FACADE_SMALL, each snapshot, at phase 5's float32 tolerances."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch import compat
    B, nlat, nlon, N = (FACADE_SMALL[k] for k in ("B", "nlat", "nlon", "N"))
    lat, lon, pv = make_pv(B, nlat, nlon, 11)
    _, grid = xt.add_latlon_metrics({"latitude": lat, "longitude": lon})
    an = xt.Contour2D(grid, pv, lt=True)
    table = an.cal_area_eqCoord_table_hist(grid.fluid_mask())
    k = keff_chain(an, grid, table, N)
    Q = an.interp_to_coords(grid.ydef, k["Yeq"], k["contour"])
    card = dict(intArea=k["intArea"], Yeq=k["Yeq"], Leq2=k["Leq2"],
                Lmin=k["Lmin"], nkeff=k["nkeff"], Q=Q,
                lwa=an.cal_local_wave_activity(an.tracer, Q),
                lwa2=an.cal_local_wave_activity2(an.tracer, Q))
    host = lambda t: t.detach().cpu().double().numpy()
    ydef, dA, dxF = host(grid.ydef), host(grid.dA), host(grid.dxF)
    grdS = host(xt.squared_gradient(an.tracer, grid))
    ones = np.ones(pv.shape[-2:])
    pre = np.linspace(-80.0, 80.0, 33)
    for b in range(B):
        q = pv[b].astype(np.float64)
        kw = dict(N=N, increase=True, lt=True)
        o = compat.keff_snapshot(q, grdS[b], ydef, dA, dxF, ones, pre,
                                 lmin="analytic", nkeff_mask=NKEFF_MASK,
                                 **kw)["origin"]
        w = compat.lwa_snapshot(q, ydef, dA, ones, **kw)
        want = {key: torch.as_tensor(v) for key, v in dict(
            intArea=o["intArea"], Yeq=o["Yeq"], Leq2=o["Leq2"],
            Lmin=o["Lmin"], nkeff=o["nkeff"], Q=w["Q"], lwa=w["lwa"],
            lwa2=w["lwa2"]).items()}
        card_vs_cpu(f"facade {B}x{nlat}x{nlon} snapshot {b} against the "
                    f"float64 oracle", want, {key: v[b] for key, v in
                                              card.items()}, phase=9)


def facade_phase(dev, drive, path_counts, era_steps, era_grid, sort_table,
                 sort_timing, sort_levels, lape_q, lape_out, lape_v):
    """Phase 9: the facade through the reference's names at ERA5 scale.
    Returns {chain: {ms, pipeline_ms, launches a step, peak GiB}} and the
    labels of the paths it drove."""
    import tempfile
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch import xcontour as xc
    names = list(next(iter(path_counts.values())))
    none = {n: 0 for n in names}
    labels, chains = [], {}

    def run(label, counts, fn):
        labels.append(label)
        return drive(label, counts, fn, exact=dict(none, **counts))

    def chain(name, fn, mirror, label, reps=LADDER_REPS, against="pipeline"):
        """Time one facade call and what it mirrors, ``against``: a call,
        or its ms measured before."""
        ms, gib = measure(fn, reps=reps)
        pipe_ms = mirror if not callable(mirror) else measure(mirror,
                                                               reps=reps)[0]
        per_step = {k: c for k, c in path_counts[label].items() if c}
        chains[name] = dict(ms=ms, against=against, against_ms=pipe_ms,
                            launches_per_step=per_step, peak_gib=gib)
        log(f"phase 9 time {name}: facade {ms:.4f} ms, {against} "
            f"{'-' if pipe_ms is None else f'{pipe_ms:.4f}'} ms, launches a "
            f"step {per_step}, peak {gib:.3f} GiB above its inputs")

    S, N = STREAM_STEPS, ERA5["N"]
    lat = era_grid.ydef.cpu().numpy()
    lon = era_grid.xdef.cpu().numpy()
    levs = np.linspace(300.0, 440.0, ERA5["B"])
    metrics, grid = xc.add_latlon_metrics({"latitude": lat, "longitude": lon,
                                           "lev": levs})
    _expect(grid.dA.device == era_steps[0].device and "drF" in metrics,
            "add_latlon_metrics: the grid is not on the card")
    q = era_steps[0]
    an = xc.Contour2D(grid, q, lt=True)
    mask = grid.fluid_mask()

    # the Keff chain (notebook 1): one table, then S steps
    def keff_run():
        table = an.cal_area_eqCoord_table_hist(mask)
        return table, [keff_chain(xc.Contour2D(grid, qs, lt=True), grid,
                                  table, N) for qs in era_steps[:S]]
    table, outs = run("facade keff era5",
                      {"squared_gradient": S, "weighted_cdf": 2 * S + 1,
                       "contour_levels": S}, keff_run)
    for i, out in enumerate(outs):
        _check_keff(out, f"facade keff era5 step {i}")
    want = xt.keff_pipeline(q, grid, N=N, lmin="analytic",
                            nkeff_mask=NKEFF_MASK, table=table)["origin"]
    facade_vs("keff era5", outs[0], want,
              ("contour", "intArea", "intgrdS", "Yeq", "dgrdSdA", "dqdA",
               "Leq2", "Lmin", "nkeff"))
    run("facade keff era5 step", {"squared_gradient": 1, "weighted_cdf": 2,
                                  "contour_levels": 1},
        lambda: keff_chain(an, grid, table, N))
    chain("keff", lambda: keff_chain(an, grid, table, N),
          lambda: xt.keff_pipeline(q, grid, N=N, lmin="analytic",
                                   nkeff_mask=NKEFF_MASK, table=table),
          "facade keff era5 step")

    # the LWA chain (notebook 2)
    Q = run("facade Q era5", {"weighted_cdf": 1, "contour_levels": 1},
            lambda: lwa_profile(an, table, N))
    lwa, contours, masks = run(
        "facade lwa era5 mask_idx", {"lwa_lin": 1},
        lambda: an.cal_local_wave_activity(q, Q, mask_idx=list(MASK_IDX)))
    pipe = xt.lwa_pipeline(q, grid, N=N, table=table)
    field_rel("facade Q era5 against lwa_pipeline", Q, pipe["Q"])

    def lwa_vs(label, got, part="all", variant2=False, key="lwa"):
        fn = xt.local_wave_activity2 if variant2 else xt.local_wave_activity
        own = fn(q, Q, grid.dA, grid.ydef, increase=True, part=part)
        field_rel(f"facade {label} era5 against local_wave_activity"
                  f"{'2' if variant2 else ''} on its Q", got, own)
        want = pipe if part == "all" else xt.lwa_pipeline(
            q, grid, N=N, part=part, table=table)
        field_rel(f"facade {label} era5 against lwa_pipeline"
                  f"{'' if part == 'all' else f'(part={part!r})'}'s {key}",
                  got, want[key], CARD_CPU_TOL["lwa"])
    lwa_vs("lwa mask_idx", lwa)
    _expect(len(contours) == len(masks) == len(MASK_IDX)
            and all(torch.equal(c, Q[:, j]) for c, j in zip(contours,
                                                             MASK_IDX)),
            "mask_idx: contours are not the profile at the surfaces")
    lwa2 = run("facade lwa2 era5", {"lwa_lin2": 1},
               lambda: an.cal_local_wave_activity2(q, Q))
    lwa_vs("lwa2", lwa2, variant2=True, key="lwa2")
    ape = run("facade ape era5", {"lwa_lin": 1},
              lambda: an.cal_local_APE(q, Q))
    lwa_vs("ape", ape)
    W = an.dA / an.dA.max() * an.dA
    mask_checks(q, Q, masks, W)
    del masks, contours
    upper = run("facade lwa upper era5", {"lwa_dense": 1},
                lambda: an.cal_local_wave_activity(q, Q, part="upper"))
    lwa_vs("lwa upper", upper, part="upper")
    del upper
    run("facade lwa era5 step", {"weighted_cdf": 1, "lwa_lin": 1,
                                 "lwa_lin2": 1, "contour_levels": 1},
        lambda: (lambda Q: (an.cal_local_wave_activity(q, Q),
                            an.cal_local_wave_activity2(q, Q)))(
            lwa_profile(an, table, N)))
    chain("lwa", lambda: (lambda Q: (an.cal_local_wave_activity(q, Q),
                                     an.cal_local_wave_activity2(q, Q)))(
              lwa_profile(an, table, N)),
          lambda: xt.lwa_pipeline(q, grid, N=N, table=table),
          "facade lwa era5 step")
    chain("lwa mask_idx", lambda: an.cal_local_wave_activity(
              q, Q, mask_idx=list(MASK_IDX)),
          lambda: an.cal_local_wave_activity(q, Q), "facade lwa era5 mask_idx",
          against="the same call without mask_idx")
    chain("lwa upper", lambda: an.cal_local_wave_activity(q, Q, part="upper"),
          lambda: xt.local_wave_activity(q, Q, grid.dA, grid.ydef,
                                         increase=True, part="upper"),
          "facade lwa upper era5", against="local_wave_activity")

    # geometry: K7 through the facade, and against the host traversal
    N7 = CLENGTH_N[0]
    lengths = run(f"facade lengths era5 N={N7}",
                  {"contour_lengths": 1, "contour_levels": 1},
                  lambda: an.cal_contour_lengths(N7, latlon=True))
    cl = xt.clength_pipeline(q, grid, N=N7, table=table)
    field_rel(f"facade lengths era5 N={N7} against clength_pipeline", lengths,
              cl["lengths"], KERNEL_BOUNDS["contour_lengths"])
    level = ERA5["B"] // 2
    host_rel = host_k7_checks(q[level], grid, cl["contour"][level])
    chain("lengths", lambda: an.cal_contour_lengths(N7, latlon=True),
          lambda: xt.clength_pipeline(q, grid, N=N7, table=table),
          f"facade lengths era5 N={N7}")

    # contour levels at prescribed latitudes, on phase 8's table
    predef = torch.linspace(*EXACT_PREDEF, device=dev)
    for method, k2 in (("broadcast", 0), ("hist", 1), ("exact", 0)):
        name = "cal_contours_at" + ("" if method == "broadcast"
                                    else f"_{method}")
        fn = lambda name=name: getattr(an, name)(predef, sort_table)
        levels = run(f"facade {name} era5",
                     {"weighted_cdf": k2, "contour_levels": 1}, fn)
        field_rel(f"facade {name} era5 against phase 8's {method}", levels,
                  sort_levels[method], LEVELS_BOUND)
        chain(name, fn, sort_timing[f"contours_at {method}"][0],
              f"facade {name} era5",
              reps=3 if method == "broadcast" else LADDER_REPS,
              against=f"phase 8's cal_contours_at {method}")

    # labelled datasets through nc3 (scipy's writer imported before the
    # timed writes)
    import scipy.io  # noqa: F401
    pre_y = torch.linspace(-88.0, 88.0, 177, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = run("facade dataset keff_lwa era5", {
            "squared_gradient": 1, "weighted_cdf": 1, "lwa_lin": 1,
            "contour_levels": 1},
            lambda: xt.keff_lwa_pipeline(q[:DATASET_B], grid, N=N,
                                         pre_y=pre_y, table=table))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds = xt.as_dataset(out, grid, pre_y=pre_y)
        copy_ms = 1e3 * (time.perf_counter() - t0)
        write_ms, read_ms, mb = dataset_round_trip("keff_lwa", ds, tmp)
        _expect(ds.dims_of("lwa") == ("time", "latitude", "longitude")
                and ds.dims_of("nkeff_at") == ("time", "latitude_interp"),
                f"as_dataset dims {ds.dims}")
        log(f"phase 9 dataset keff_lwa era5 B={DATASET_B}: as_dataset "
            f"(host copies) {copy_ms:.2f} ms, to_nc3 {write_ms:.2f} ms, "
            f"load_dataset {read_ms:.2f} ms, {mb:.1f} MiB of variables: "
            f"round trip exact")
        k = outs[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = an.interp_to_dataset(
            predef, k["Yeq"], {"q": k["contour"], "latEq": k["Yeq"],
                               "area": k["intArea"], "nkeff": k["nkeff"]},
            batch_dims=("time",),
            batch_coords={"time": np.arange(ERA5["B"], dtype=np.float64)})
        interp_ms = 1e3 * (time.perf_counter() - t0)
        iwrite_ms, iread_ms, imb = dataset_round_trip("interp", ids, tmp)
        _expect(ids.dims_of("q") == ("time", "latitude"),
                f"interp_to_dataset dims {ids.dims}")
        log(f"phase 9 dataset interp_to_dataset era5: {interp_ms:.2f} ms, "
            f"to_nc3 {iwrite_ms:.2f} ms, load_dataset {iread_ms:.2f} ms, "
            f"{imb:.3f} MiB: round trip exact")
    chains["dataset"] = dict(as_dataset_ms=copy_ms, to_nc3_ms=write_ms,
                             load_ms=read_ms, mib=mb,
                             interp_to_dataset_ms=interp_ms,
                             interp_to_nc3_ms=iwrite_ms)

    # LAPE: the MITgcm metric constructor and the vendored Contour2D on the x-z plane
    def lape_run():
        metrics, mgrid = xc.add_MITgcm_missing_metrics(lape_v)
        a1 = xc.Contour2D(mgrid, lape_q, increase=False, lt=False)
        a2 = xc.Contour2D.from_arrays(lape_q, metrics["yA"], lape_v["Z"],
                                      lape_v["XC"], increase=False, lt=False)
        return [a.cal_local_APE(lape_q, lape_out["Q"]) for a in (a1, a2)], a1
    (ape_grid, ape_arrays), a1 = run("facade lape", {"lwa_lin": 2}, lape_run)
    field_rel("facade lape (add_MITgcm_missing_metrics) against phase 4",
              ape_grid, lape_out["lwa"])
    field_rel("facade lape (from_arrays) against phase 4", ape_arrays,
              lape_out["lwa"])
    run("facade lape step", {"lwa_lin": 1},
        lambda: a1.cal_local_APE(lape_q, lape_out["Q"]))
    chain("lape", lambda: a1.cal_local_APE(lape_q, lape_out["Q"]),
          lambda: xt.local_wave_activity(lape_q, lape_out["Q"], a1.dA,
                                         a1.grid.ydef, increase=False),
          "facade lape step", against="local_wave_activity")

    facade_small_oracle(dev)
    return chains, labels, host_rel


# -- phase 10: an archive through the runner and the CLI --------------------

def nc3_archive(tmp, name, pv, lat, lon, level, time_axis=True):
    """Write ``pv`` (time, level, lat, lon) or (level, lat, lon) as classic
    netCDF with the latitude stored as given; returns the path and MB."""
    from xcontour_tpu_torch.utils.ncio import save_dataset_nc3
    dims = (("time",) if time_axis else ()) + ("level", "latitude",
                                               "longitude")
    coords = {"level": np.asarray(level, np.int32), "latitude": lat,
              "longitude": lon}
    if time_axis:
        coords["time"] = np.arange(pv.shape[0], dtype=np.int32)
    path = os.path.join(tmp, f"{name}.nc")
    save_dataset_nc3(path, {"pv": pv}, {"pv": dims}, coords=coords)
    return path, os.path.getsize(path) / 2 ** 20


def archive_times(tmp):
    """ARCHIVE['time'], cut (never the grid) where the temporary disk cannot
    hold the archive and what the phase writes beside it (CLI_DISK_FACTOR
    archives at once)."""
    import shutil
    one = ARCHIVE["level"] * ARCHIVE["nlat"] * ARCHIVE["nlon"] * 4
    free = shutil.disk_usage(tmp).free
    T = ARCHIVE["time"]
    while T > 3 and CLI_DISK_FACTOR * T * one > free:
        T -= 1
    if T < ARCHIVE["time"]:
        log(f"phase 10 disk: {free / 2 ** 30:.2f} GiB free under {tmp}; "
            f"the archive is cut to {T} times of {ARCHIVE['time']}")
    _expect(CLI_DISK_FACTOR * T * one <= free,
            f"phase 10: {free / 2 ** 30:.2f} GiB free under {tmp}, too "
            "little for three times of the archive")
    return T, free


def run_cli(argv):
    """cli.main(argv) with its standard output captured; returns (rc, the
    lines, host seconds)."""
    import contextlib
    import io
    from xcontour_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines(), time.perf_counter() - t0


RUNNER_LINE = re.compile(r"\[runner\] chunk (\d+)/\d+: \d+ snapshots in "
                         r"[0-9.]+s \(([0-9.]+)/s\)")


def runner_rates(lines):
    """{chunk: snapshots/s} from the runner's log lines."""
    return {int(m.group(1)): float(m.group(2))
            for m in map(RUNNER_LINE.search, lines) if m}


def cli_vs(label, got, want, against):
    """Phase 10's outputs against keff_lwa_pipeline's (or another run's):
    phase 9's comparator and bounds, the field lwa within
    CARD_CPU_TOL['lwa'] of its maximum."""
    keys = [k for k in want if k != "lwa" and k in got]
    facade_vs(label, got, want, keys, what="phase 10 cli", against=against)
    if "lwa" in want:
        field_rel(f"cli {label} lwa against {against}", got["lwa"],
                  want["lwa"], CARD_CPU_TOL["lwa"], what="phase 10")


def nc_tensors(path, dev, names=None):
    """The float variables of a netCDF file as float32 tensors on ``dev``
    (the output's 'levels' under the pipeline's name 'contour'), with the
    Dataset."""
    from xcontour_tpu_torch.utils.ncio import load_dataset
    ds = load_dataset(path)
    out = {}
    for k in names or ds.variables:
        a = np.asarray(ds[k])
        if a.dtype.kind == "f":
            out["contour" if k == "levels" else k] = torch.as_tensor(
                a.astype(np.float32)).to(dev)
    return out, ds


def keff_lwa_step(grid, N):
    """The CLI's keff-lwa chunk step (own table, flattened, no table)."""
    import xcontour_tpu_torch as xt

    def step(x):
        flat = xt.flatten_output(xt.keff_lwa_pipeline(x, grid, N=N))
        flat.pop("table", None)
        return flat
    return step


def fetch_packed(out, dev):
    """The JAX runner's packed fetch on the card: each same-(dtype, batch)
    group concatenated on the device and copied to pinned host memory
    once, then one synchronize."""
    groups = {}
    for k, v in out.items():
        groups.setdefault((v.dtype, v.shape[0]), []).append(k)
    held = []
    for (dtype, B), ks in groups.items():
        flat = torch.cat([out[k].reshape(B, -1) for k in ks], dim=1)
        h = torch.empty(flat.shape, dtype=dtype, pin_memory=True)
        h.copy_(flat, non_blocking=True)
        held.append((ks, h.numpy()))
    torch.cuda.current_stream(dev).synchronize()
    res = {}
    for ks, packed in held:
        lo = 0
        for k in ks:
            w = out[k][0].numel()
            res[k] = packed[:, lo:lo + w].reshape(tuple(out[k].shape))
            lo += w
    return res


def stage_times(tracer, step, dev, tmp):
    """Each stage of the streamed run alone, chunk by chunk: the host
    path's read (the memmap slice, the latitude flip and the byte swap of
    _LazyField); the raw path's copy of the file's bytes into a pinned
    block and its decode on the card (CUDA events around the wrapper), the
    decoded chunk the host path's bit for bit; the host path's copy into
    pinned memory, the host-to-device copy (CUDA events), the step (host
    clock around it and a synchronize), the fetch three ways (the runner's
    pinned per-key copies with one synchronize, per-key .cpu(), and the JAX
    runner's packing), bit for bit alike, and the .npz write."""
    from xcontour_tpu_torch import runner
    from xcontour_tpu_torch.kernels import decode
    B = ARCHIVE["level"]
    planes = tracer.raw_planes()
    _expect(planes is not None, "phase 10: the archive offers no raw planes")
    mask = None if planes.mask is None else \
        torch.from_numpy(planes.mask).to(dev)
    rows = []
    for k in range(tracer.shape[0] // B):
        r = {}
        t0 = time.perf_counter()
        arr = tracer[k * B:(k + 1) * B]
        r["read_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        raw = torch.empty(arr.shape[:-1] + (arr.shape[-1]
                                             * planes.file_dtype.itemsize,),
                          dtype=torch.uint8, pin_memory=True)
        tracer.raw_into(slice(k * B, (k + 1) * B), raw.numpy())
        r["raw_read_ms"] = 1e3 * (time.perf_counter() - t0)
        raw = raw.to(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        y = decode.decode_planes(raw, planes, mask)
        stop.record()
        torch.cuda.synchronize()
        r["decode_ms"] = start.elapsed_time(stop)
        _expect(same_bits(y, torch.from_numpy(arr).to(dev)),
                f"phase 10 decode: chunk {k} differs from the host path's")
        del raw, y
        t0 = time.perf_counter()
        host = torch.empty(arr.shape, dtype=torch.float32, pin_memory=True)
        np.copyto(host.numpy(), arr)
        r["pin_ms"] = 1e3 * (time.perf_counter() - t0)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        x = host.to(dev, non_blocking=True)
        stop.record()
        torch.cuda.synchronize()
        r["h2d_ms"] = start.elapsed_time(stop)
        r["h2d_gbps"] = arr.nbytes / 1e6 / r["h2d_ms"]
        t0 = time.perf_counter()
        out = step(x)
        torch.cuda.synchronize()
        r["step_ms"] = 1e3 * (time.perf_counter() - t0)
        fetched = {}
        for name, fn in (("fetch", lambda: runner._fetch(out, dev)),
                         ("fetch_cpu", lambda: {key: v.cpu().numpy()
                                                for key, v in out.items()}),
                         ("fetch_packed", lambda: fetch_packed(out, dev))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fetched[name] = fn()
            r[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0)
        for name in ("fetch_cpu", "fetch_packed"):
            for key, v in fetched["fetch"].items():
                _expect(np.array_equal(v, fetched[name][key], equal_nan=True)
                        and v.dtype == fetched[name][key].dtype,
                        f"phase 10 {name}: {key} differs from the runner's "
                        "fetch")
        path = os.path.join(tmp, f"stage_ck{k:05d}.npz")
        t0 = time.perf_counter()
        np.savez(path + ".tmp.npz", **fetched["fetch"])
        os.replace(path + ".tmp.npz", path)
        r["write_ms"] = 1e3 * (time.perf_counter() - t0)
        r["npz_mb"] = os.path.getsize(path) / 2 ** 20
        os.remove(path)
        rows.append(r)
    return rows


def busy_share(trace_dir):
    """(kernel busy share, copy busy share, window ms, kernels, {span: ms})
    over the streamed run in a utils.prof trace: the device's merged kernel
    (and memcpy) intervals within the CLI's cli.stream range (the runner
    and, under --stem, load_chunks), and the host ms of each of the CLI's
    ranges (cli.open, cli.stream, cli.label, cli.write)."""
    import glob
    files = glob.glob(os.path.join(trace_dir, "trace_*.json"))
    _expect(len(files) == 1, f"phase 10: trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") == "cli.stream"]
    _expect(len(spans) == 1, f"phase 10: {len(spans)} cli.stream ranges")
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)

    def merged(cat):
        ivs = sorted((max(float(e["ts"]), lo),
                      min(float(e["ts"]) + float(e["dur"]), hi))
                     for e in events if e.get("cat") == cat and "dur" in e
                     and float(e["ts"]) < hi
                     and float(e["ts"]) + float(e["dur"]) > lo)
        total, cur_s, cur_e = 0.0, None, None
        for s, e in ivs:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total, len(ivs)

    kern, nk = merged("kernel")
    copy, _ = merged("gpu_memcpy")
    _expect(nk > 0, "phase 10: the trace holds no kernel in the run")
    cli = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("cat") == "user_annotation" and name.startswith("cli."):
            cli[name] = cli.get(name, 0.0) + float(e["dur"]) / 1e3
    return kern / (hi - lo), copy / (hi - lo), (hi - lo) / 1e3, nk, cli


def bf16_round(a):
    """float32 -> bfloat16 -> float32 on the host, to nearest even (the rule
    the JAX runner's ml_dtypes cast and the port's wire follow), in numpy."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    r = ((u + np.uint32(0x7FFF) + ((u >> 16) & 1)) >> 16) << 16
    return np.where(np.isnan(a), np.float32(np.nan),
                    r.astype(np.uint32).view(np.float32))


def kill_and_resume(drive, none, argv, stem, nchunk, root):
    """SIGKILL ``python -m xcontour_tpu_torch`` once two chunk files exist,
    rerun in process: the surviving files are unchanged and only the
    missing chunks are computed.  Returns (survivors, killed, resume
    seconds)."""
    import glob
    import hashlib
    import signal

    def chunks():
        return sorted(f for f in glob.glob(f"{stem}_ck*.npz")
                      if not f.endswith(".tmp.npz"))

    os.makedirs(os.path.dirname(stem), exist_ok=True)
    err_path = stem + ".stderr"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "xcontour_tpu_torch", *argv], cwd=root,
            stdout=subprocess.DEVNULL, stderr=err)
        killed, deadline = False, time.time() + 600
        try:
            while time.time() < deadline and proc.poll() is None:
                if len(chunks()) >= 2:
                    proc.send_signal(signal.SIGKILL)
                    killed = True
                    break
                time.sleep(0.002)
        finally:
            if proc.poll() is None and not killed:
                proc.kill()
            proc.wait(timeout=120)
    if not killed:
        with open(err_path) as f:
            _expect(proc.returncode == 0, f"phase 10 kill: the CLI process "
                    f"failed (rc {proc.returncode}): {f.read()[-2000:]}")
        # the process finished first: tear the archive as a kill would
        for k in (1, nchunk - 1):
            os.remove(f"{stem}_ck{k:05d}.npz")
    kept = {}
    for f in chunks():
        with open(f, "rb") as fh:
            kept[f] = (hashlib.sha256(fh.read()).hexdigest(),
                       os.stat(f).st_mtime_ns)
    _expect(0 < len(kept) < nchunk,
            f"phase 10 kill: {len(kept)} of {nchunk} chunks survived")
    missing = nchunk - len(kept)
    t0 = time.perf_counter()
    rc, lines, _ = drive(
        "cli keff-lwa era5 resume", {}, lambda: run_cli(argv),
        exact=dict(none, squared_gradient=missing,
                   weighted_cdf=2 * missing, lwa_lin=missing,
                   decode_planes=missing, contour_levels=missing))
    seconds = time.perf_counter() - t0
    _expect(rc == 0, "phase 10 resume: the CLI failed")
    skipped = sum("exists, skipped" in ln for ln in lines)
    _expect(skipped == len(kept), f"phase 10 resume: {skipped} chunks "
            f"skipped, {len(kept)} survived")
    for f, (digest, mtime) in kept.items():
        with open(f, "rb") as fh:
            _expect(hashlib.sha256(fh.read()).hexdigest() == digest
                    and os.stat(f).st_mtime_ns == mtime,
                    f"phase 10 resume: surviving {f} changed")
    _expect(len(chunks()) == nchunk, "phase 10 resume: chunks missing")
    return len(kept), killed, seconds


def fault_checks(dev, tracer, step, ref, tmp):
    """The runner's failure handling on the card: a step that raises once
    on chunk 1 heals under retries=1 without a marker; on_error='skip'
    writes the .failed record and load_chunks(allow_failed=True) NaN-fills
    it; a chunk the f16 wire cannot carry raises WireRangeError at once."""
    from xcontour_tpu_torch import runner
    B = ARCHIVE["level"]
    nchunk = tracer.shape[0] // B
    keys = ("intArea", "Yeq", "Leq2", "nkeff", "Q")

    def small(x):       # the real step, but the field-sized lwa left out
        return {k: v for k, v in step(x).items() if k in keys + ("contour",)}

    calls = []

    def flaky(x):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected fault on chunk 1")
        return small(x)

    lines = []
    stem = os.path.join(tmp, "retry")
    runner.run_batched(flaky, tracer, batch=B, out_stem=stem, retries=1,
                       retry_wait=0.0, device=dev, log=lines.append)
    import glob
    _expect(not glob.glob(stem + "_ck*.failed"),
            "phase 10 retry: a .failed marker was left")
    _expect(len(calls) == nchunk + 1 and
            sum("attempt 1 failed" in ln for ln in lines) == 1,
            f"phase 10 retry: {len(calls)} step calls, log {lines}")
    healed = {k: torch.as_tensor(v).to(dev)
              for k, v in runner.load_chunks(stem).items()}
    healed = {k: v.reshape(ref[k].shape) for k, v in healed.items()}
    cli_vs("retry after an injected fault", healed,
           {k: ref[k] for k in keys}, "keff_lwa_pipeline")

    def broken(x):
        calls.append(1)
        if len(calls) == nchunk + 4:
            raise RuntimeError("injected fault on chunk 2")
        return small(x)

    stem = os.path.join(tmp, "skip")
    runner.run_batched(broken, tracer, batch=B, out_stem=stem,
                       on_error="skip", device=dev, log=lines.append)
    with open(stem + "_ck00002.failed") as f:
        rec = json.load(f)
    _expect(rec["chunk"] == 2 and rec["nvalid"] == B
            and "injected fault on chunk 2" in rec["error"],
            f"phase 10 skip: record {rec}")
    got = runner.load_chunks(stem, allow_failed=True, expect_chunks=nchunk)
    _expect(bool(np.isnan(got["Yeq"][2 * B:3 * B]).all()),
            "phase 10 skip: the failed chunk is not NaN-filled")
    _expect(bool(np.isfinite(got["intArea"][:2 * B]).all()),
            "phase 10 skip: the healthy chunks lost values")

    class Scaled:       # a mis-scaled variable: |pv| * 1e9 past f16's max
        shape, dtype, ndim = tracer.shape, tracer.dtype, 3

        def __getitem__(self, sl):
            return tracer[sl] * np.float32(1e9)

    steps, lines = [], []
    try:
        runner.run_batched(lambda x: steps.append(1) or small(x), Scaled(),
                           batch=B, retries=3, on_error="skip", device=dev,
                           transfer_dtype=torch.float16, log=lines.append)
        raise AssertionError("phase 10 wire: no WireRangeError")
    except runner.WireRangeError as e:
        _expect(not steps and not lines, f"phase 10 wire: retried or "
                f"skipped before raising ({lines})")
        wire_msg = str(e)
    log(f"phase 10 faults: a fault on chunk 1 healed under retries=1 with "
        f"no marker; on_error='skip' wrote {rec} and load_chunks NaN-filled "
        f"it; the f16 wire raised at once: {wire_msg[:80]}...")


def wire_checks(dev, chunk0):
    """One chunk of 15 through the f16 and bf16 wires: the upcast device
    input equals the host-rounded array bit for bit (NaN where it is NaN),
    and the outputs stay within WIRE_BOUND of the chunk's largest magnitude
    of the float32 run's (the wire's own bound)."""
    from xcontour_tpu_torch import runner
    seen = {}

    def cap(x):
        seen["x"] = x.clone()
        return {"mean": torch.nanmean(x, dim=(-2, -1)), "double": x * 2}

    quiet = dict(batch=chunk0.shape[0], device=dev, log=lambda s: None)
    full = runner.run_batched(cap, chunk0, **quiet)
    scale = float(np.nanmax(np.abs(chunk0)))
    res = {}
    for name, wire, host in (
            ("f16", torch.float16,
             chunk0.astype(np.float16).astype(np.float32)),
            ("bf16", torch.bfloat16, bf16_round(chunk0))):
        out = runner.run_batched(cap, chunk0, transfer_dtype=wire, **quiet)
        x = seen["x"].cpu().numpy()
        nan = np.isnan(host)
        _expect(x.dtype == np.float32 and np.array_equal(np.isnan(x), nan)
                and np.array_equal(x[~nan].view(np.uint32),
                                   host[~nan].view(np.uint32)),
                f"phase 10 wire {name}: the device input differs from the "
                "host rounding")
        errs = {k: float(np.nanmax(np.abs(out[k] - full[k])))
                / (scale * (2 if k == "double" else 1)) for k in out}
        for k, e in errs.items():
            _expect(e <= WIRE_BOUND[name], f"phase 10 wire {name}: {k} "
                    f"{e:.3e} of scale > {WIRE_BOUND[name]:g}")
        res[name] = errs
        log(f"phase 10 wire {name}: device input bit for bit the host "
            f"rounding; outputs against float32 {errs} of scale (bound "
            f"{WIRE_BOUND[name]:g})")
    return res


def cli_phase(dev, drive, path_counts, peaks, card, then=None):
    """Phase 10: an ERA5-width archive through the runner and the CLI;
    ``then(path, base argv, the --stem run's outputs, times, tmp)`` runs
    on the archive before it is removed."""
    import shutil
    import tempfile
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch import runner
    from xcontour_tpu_torch.utils import prof
    none = {n: 0 for n in next(iter(path_counts.values()))}
    labels, res = [], {}
    root = os.path.dirname(os.path.abspath(__file__))
    A, N = ARCHIVE, ARCHIVE["N"]
    dev_args = ["--device", dev.type]

    def run(label, counts, argv):
        labels.append(label)
        rc, lines, secs = drive(label, {k: c for k, c in counts.items() if c},
                                lambda: run_cli(argv),
                                exact=dict(none, **counts))
        _expect(rc == 0, f"phase 10 {label}: rc {rc}")
        return lines, secs

    with tempfile.TemporaryDirectory() as tmp:
        T, free = archive_times(tmp)
        t0 = time.perf_counter()
        pv = np.empty((T, A["level"], A["nlat"], A["nlon"]), np.float32)
        for t in range(T):
            lat, lon, pv[t] = make_pv(A["level"], A["nlat"], A["nlon"],
                                      A["seed"] + t)
        from xcontour_tpu_torch.utils.synth import synth_pv
        level = synth_pv(nlev=A["level"], nlat=2, nlon=2)[0]["level"]
        path, mb = nc3_archive(tmp, "era5", pv[:, :, ::-1], lat[::-1].copy(),
                               lon, level)
        log(f"phase 10 set-up: pv{pv.shape} float32, latitude descending, "
            f"{mb:.1f} MB nc3 in {time.perf_counter() - t0:.2f} s "
            f"({free / 2 ** 30:.1f} GiB free)")
        S = T * A["level"]
        base = ["keff-lwa", path, "--var", "pv", "-N", str(N), "--batch",
                str(A["level"]), "--format", "nc3", *dev_args]
        # the nc3 memmap takes the runner's raw path: one decode and one
        # E call a chunk
        per_run = {"squared_gradient": T, "weighted_cdf": 2 * T,
                   "lwa_lin": T, "decode_planes": T, "contour_levels": T}

        # the reference: keff_lwa_pipeline on the same snapshots, on the card
        grid = xt.from_latlon(lat, lon, device=dev)
        step = keff_lwa_step(grid, N)
        ref = [step(torch.as_tensor(pv[t]).to(dev)) for t in range(T)]
        ref = {k: torch.stack([r[k] for r in ref]) for k in ref[0]}

        # --stem (the production resume path), then in memory
        stem = os.path.join(tmp, "ck", "era5")
        out_stem = os.path.join(tmp, "stem.nc")
        lines, secs = run("cli keff-lwa era5 --stem", per_run,
                          base + ["--stem", stem, "--out", out_stem])
        res["stem"] = dict(s=secs, rate=S / secs, chunks=runner_rates(lines),
                           peak_gib=peaks["cli keff-lwa era5 --stem"])
        got, ds = nc_tensors(out_stem, dev)
        _expect(tuple(ds.dims_of("lwa")) == ("time", "level", "latitude",
                                            "longitude"),
                f"phase 10: lwa dims {ds.dims_of('lwa')}")
        _expect(np.array_equal(np.asarray(ds["latitude"]),
                               lat.astype(np.float32)),
                "phase 10: latitude is not the ascending coordinate")
        cli_vs("keff-lwa --stem", got, ref, "keff_lwa_pipeline")
        os.remove(out_stem)
        shutil.rmtree(os.path.dirname(stem))
        out_mem = os.path.join(tmp, "mem.nc")
        lines, secs = run("cli keff-lwa era5 in memory", per_run,
                          base + ["--out", out_mem])
        res["memory"] = dict(s=secs, rate=S / secs,
                             chunks=runner_rates(lines),
                             peak_gib=peaks["cli keff-lwa era5 in memory"])
        mem, _ = nc_tensors(out_mem, dev)
        os.remove(out_mem)
        cli_vs("keff-lwa in memory", mem, got, "keff-lwa --stem")
        log(f"phase 10 decode: "
            f"{path_counts['cli keff-lwa era5 in memory']['decode_planes']} "
            f"launches for {T} chunks of the in-memory run (the count set to "
            "0 just before)")
        if then is not None:
            then(path, base, got, T, tmp)
        for name in ("stem", "memory"):
            r = res[name]
            log(f"phase 10 rate keff-lwa era5 {name}: {S} snapshots in "
                f"{r['s']:.3f} s end to end ({r['rate']:.1f} snapshots/s, "
                f"open to the nc3 write), runner per chunk "
                f"{list(r['chunks'].values())} snapshots/s, peak {r['peak_gib']:.3f} GiB ({card})")

        # the in-memory run traced: the device's busy share
        trace_dir = os.path.join(tmp, "trace")
        out_tr = os.path.join(tmp, "traced.nc")
        with prof.trace(trace_dir):
            rc, _, secs = run_cli(base + ["--out", out_tr])
        _expect(rc == 0, "phase 10 traced run failed")
        os.remove(out_tr)
        kern, copy, window, nk, spans = busy_share(trace_dir)
        res["busy"] = dict(kernel=kern, copy=copy, window_ms=window,
                           kernels=nk, traced_s=secs, cli_ms=spans)
        log(f"phase 10 busy keff-lwa era5 in memory (traced, {secs:.3f} s): "
            f"kernels {100 * kern:.2f}% and copies {100 * copy:.2f}% of the "
            f"streamed run's {window:.1f} ms (cli.stream, {nk} kernels); "
            f"the CLI's stages, host ms: {spans} ({card})")

        # each stage alone, and the compute-only rate on the card
        tracer = cli_load(path, dev)
        stages = stage_times(tracer, step, dev, tmp)
        res["stages"] = stages
        for key in stages[0]:
            vals = [r[key] for r in stages]
            log(f"phase 10 stage {key}: median {statistics.median(vals):.3f}"
                f" per chunk {[round(v, 3) for v in vals]}")
        steps_s = sum(r["step_ms"] for r in stages) / 1e3
        res["compute_rate"] = S / steps_s
        log(f"phase 10 rate keff-lwa era5 compute only: "
            f"{res['compute_rate']:.1f} snapshots/s (the CLI's step on "
            f"chunks already on the card, host clock) ({card})")

        # kill and resume
        stem2 = os.path.join(tmp, "kill", "era5")
        out_kill = os.path.join(tmp, "kill.nc")
        survivors, killed, secs = kill_and_resume(
            drive, none, base + ["--stem", stem2, "--out", out_kill], stem2,
            T, root)
        labels.append("cli keff-lwa era5 resume")
        back, _ = nc_tensors(out_kill, dev)
        os.remove(out_kill)
        shutil.rmtree(os.path.dirname(stem2))
        cli_vs("keff-lwa killed and resumed", back, got,
               "the uninterrupted --stem run")
        res["kill"] = dict(survivors=survivors, killed=killed, resume_s=secs)
        log(f"phase 10 kill: {'SIGKILL' if killed else 'no kill (finished '
            'first; chunks removed)'} with {survivors} of {T} chunks "
            f"written; resumed in process in {secs:.3f} s, the survivors "
            "unchanged")

        fault_checks(dev, tracer, step, ref, tmp)
        res["wire"] = wire_checks(dev, tracer[0:A["level"]])

        # --transfer through the CLI on one time
        one = {k: v[:1] for k, v in got.items()}
        for mode in ("f16", "bf16"):
            out_w = os.path.join(tmp, f"wire_{mode}.nc")
            run(f"cli keff-lwa era5 --transfer {mode}",
                {"squared_gradient": 1, "weighted_cdf": 2, "lwa_lin": 1,
                 "contour_levels": 1},
                base + ["--isel", "time=0", "--transfer", mode,
                        "--out", out_w])
            w, _ = nc_tensors(out_w, dev)
            os.remove(out_w)
            A0 = one["intArea"][0]
            top = A0.amax(-1, keepdim=True)
            ok = torch.minimum(A0, top - A0) >= EXTREME_AREA * top
            dy = (w["Yeq"] - one["Yeq"][0]).abs()[ok].max().item()
            # the JAX suite's bound for the f16 wire through the CLI
            # (tests/test_runner_checks.py test_cli_transfer_flag)
            _expect(mode != "f16" or dy <= 1.0, f"phase 10 --transfer "
                    f"{mode}: Yeq moved {dy:.3f} degrees")
            log(f"phase 10 --transfer {mode}: Yeq within {dy:.4f} degrees of "
                "the float32 run off the extreme contours"
                + (" (bound 1)" if mode == "f16" else ""))

        # the other subcommands on one time (15 levels)
        one_time = ["--isel", "time=0", "--var", "pv", "--format", "nc3",
                    *dev_args]
        shapes = {}
        for label, cmd, extra, counts, var, shape in (
                ("lwa", "lwa", [], {"weighted_cdf": 2, "lwa_lin": 1,
                                    "lwa_lin2": 1, "decode_planes": 1,
                                    "contour_levels": 1},
                 "lwa2", (A["level"], A["nlat"], A["nlon"])),
                ("lwa dense", "lwa", ["--lwa-method", "dense"],
                 {"weighted_cdf": 2, "lwa_dense": 2, "decode_planes": 1,
                  "contour_levels": 1},
                 "lwa", (A["level"], A["nlat"], A["nlon"])),
                ("keff", "keff", [], {"squared_gradient": 1,
                                      "weighted_cdf": 2, "decode_planes": 1,
                                      "contour_levels": 1},
                 "nkeff", (A["level"], 121)),
                ("clength N=401", "clength", ["-N", "401"],
                 {"weighted_cdf": 2, "contour_lengths": 1,
                  "clength_weights": 1, "decode_planes": 1,
                  "contour_levels": 1}, "lengths",
                 (A["level"], 401)),
                ("local-length", "local-length",
                 ["--window", str(LOCAL["window"]), "--stride",
                  str(LOCAL["stride"])], {"local_lengths": 1,
                                          "window_means": 1,
                                          "decode_planes": 1},
                 "llen", (A["level"],
                          (A["nlat"] - LOCAL["window"]) // LOCAL["stride"] + 1,
                          (A["nlon"] - LOCAL["window"]) // LOCAL["stride"]
                          + 1))):
            out_c = os.path.join(tmp, "sub.nc")
            run(f"cli {label} era5", counts,
                [cmd, path, *extra, *one_time, "--out", out_c])
            shapes[label] = check_cli_output(out_c, var, shape, label)
        # the headline grid (fractal) and the tall grid (K6), own files
        hlat, hlon, hpv = make_pv(HEADLINE["B"], HEADLINE["nlat"],
                                  HEADLINE["nlon"], 100)
        hpath, _ = nc3_archive(tmp, "headline", hpv, hlat, hlon,
                               np.arange(HEADLINE["B"]), time_axis=False)
        out_c = os.path.join(tmp, "sub.nc")
        run("cli fractal headline", {"weighted_cdf": 2,
                                     "contour_lengths":
                                         len(FRACTAL_STRIDES),
                                     "decode_planes": 1, "box_counts": 1,
                                     "contour_levels": 1},
            ["fractal", hpath, "--var", "pv", "-N", str(HEADLINE["N"]),
             "--batch", str(HEADLINE["B"]), "--format", "nc3", *dev_args,
             "--out", out_c])
        shapes["fractal"] = check_cli_output(
            out_c, "D", (HEADLINE["B"], HEADLINE["N"]), "fractal")
        tlat, tlon, tpv = make_pv(TALL["B"], TALL["nlat"], TALL["nlon"], 200)
        tpath, _ = nc3_archive(tmp, "tall", tpv, tlat, tlon,
                               np.arange(TALL["B"]), time_axis=False)
        run("cli lwa dense tall", {"weighted_cdf": 2, "lwa_dense_tall": 2,
                                   "decode_planes": 1, "contour_levels": 1},
            ["lwa", tpath, "--var", "pv", "-N", str(TALL["N"]),
             "--lwa-method", "dense", "--format", "nc3", *dev_args,
             "--out", out_c])
        shapes["lwa dense tall"] = check_cli_output(
            out_c, "lwa", (TALL["B"], TALL["nlat"], TALL["nlon"]),
            "lwa dense tall")
        log(f"phase 10 subcommands: outputs {shapes}")

        refusal_checks(path, tmp)
    return res, labels


def clength_launch_checks(era_steps, era_grid):
    """Phase 10: one launch of G a clength_pipeline call, eager (no table,
    as the CLI's clength calls it) and replayed (the table given, as
    era5.clength calls it: a warm-up, a capture, two replays), a fresh
    graph cache."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch import pipeline
    from xcontour_tpu_torch.kernels import gradw
    kept = pipeline.GRAPHS
    pipeline.GRAPHS = g = pipeline.Graphs()
    try:
        table = xt.cal_area_eqCoord_table_hist(
            era_grid.fluid_mask(), era_grid.ydef, era_grid.dA, increase=True,
            lt=True)
        per_call = []
        for q, t in [(era_steps[0], None)] + [(era_steps[i % 2], table)
                                               for i in range(4)]:
            n0 = gradw.KERNEL.launches
            xt.clength_pipeline(q, era_grid, N=CLENGTH_N[1], table=t)
            torch.cuda.synchronize()
            per_call.append(gradw.KERNEL.launches - n0)
        _expect(per_call == [1] * 5 and (g.captures, g.replays) == (1, 3),
                f"phase 10 clength: G launches a call {per_call}, captures "
                f"{g.captures}, replays {g.replays}")
        log(f"phase 10 clength launches: G {per_call} a call (eager without "
            f"a table; then warm-up, capture, replay, replay), captures "
            f"{g.captures}, replays {g.replays}")
    finally:
        pipeline.GRAPHS = kept
        del g
        torch.cuda.empty_cache()


def check_cli_output(path, var, shape, label):
    """A CLI output: ``var`` of ``shape`` with finite values, latitude
    ascending; the file is removed.  Returns the shape."""
    from xcontour_tpu_torch.utils.ncio import load_dataset
    ds = load_dataset(path)
    a = np.asarray(ds[var])
    _expect(shape is None or a.shape == shape,
            f"phase 10 {label}: {var} has shape {a.shape}, not {shape}")
    _expect(bool(np.isfinite(a).any()), f"phase 10 {label}: {var} has no "
            "finite value")
    lat = np.asarray(ds["latitude"])
    _expect(bool((np.diff(lat) > 0).all()), f"phase 10 {label}: latitude "
            "not ascending")
    del ds
    os.remove(path)
    return a.shape


def cli_load(path, dev):
    """The CLI's streaming view of the archive (a _LazyField over the nc3
    memmap)."""
    import argparse
    from xcontour_tpu_torch import cli
    args = argparse.Namespace(input=path, var="pv", dims=None, isel=None,
                              scale_var=None, mask_var=None,
                              mask_from_nan=False, batch=ARCHIVE["level"],
                              f64=False, device=dev.type)
    return cli._load_field(args)[0]


def refusal_checks(path, tmp):
    """What the CLI refuses on the card: --f64 (the kernels take float32)
    and --format nc4 where h5py is missing, each with its message and
    before any chunk runs; and `info` lists the file."""
    import importlib.util
    from xcontour_tpu_torch import cli
    out = os.path.join(tmp, "refused.nc")
    try:
        run_cli(["keff", path, "--var", "pv", "--f64", "--out", out])
        raise AssertionError("phase 10: --f64 on the card did not exit")
    except SystemExit as e:
        _expect("--device cpu" in str(e), f"phase 10 --f64: {e}")
        f64_msg = str(e)
    if importlib.util.find_spec("h5py") is None:
        try:
            run_cli(["keff", path, "--var", "pv", "--out", out])
            raise AssertionError("phase 10: nc4 without h5py did not exit")
        except SystemExit as e:
            _expect("--format nc3" in str(e), f"phase 10 nc4: {e}")
            nc4_msg = str(e)
    else:
        nc4_msg = "h5py is installed here: nc4 allowed"
    _expect(not os.path.exists(out), "phase 10: a refused run wrote output")
    rc, lines, _ = run_cli(["info", path])
    _expect(rc == 0 and any(ln.startswith("pv  dims=('time', 'level', "
                                          "'latitude', 'longitude')")
                            for ln in lines), f"phase 10 info: {lines}")
    log(f"phase 10 refusals: --f64 '{f64_msg}'; nc4 '{nc4_msg}'; info: "
        f"{[ln for ln in lines if ln.startswith('pv ')][0]}")


# -- phase 11: the sharded path (xcontour_tpu_torch.parallel) ---------------

def par_vs(label, got, want, bound):
    """A sharded function's output against its unsharded counterpart on the
    same card tensors: bit for bit, or within ``bound`` of the largest
    magnitude (the NaN patterns equal).  Returns the relative error."""
    same = torch.equal(torch.nan_to_num(got, nan=0.0),
                       torch.nan_to_num(want, nan=0.0)) and \
        torch.equal(torch.isnan(got), torch.isnan(want))
    _, rel = rel_err(got, want)
    log(f"phase 11 {label}: " + ("bit for bit" if same else
                                 f"rel {rel:.3e} bound {bound:g}"))
    _expect(same or rel <= bound, f"phase 11 {label}: rel {rel:.3e} > "
            f"{bound:g}")
    return 0.0 if same else rel


def par_step_vs(label, got, want):
    """A sharded step's outputs against the unsharded step's: phase 9's
    comparator (K2's float atomics sum in another order each launch, and
    the x ranks' partial sums add in another order again) for the
    contour-space keys; the profile Q on the grid, read through the table
    lookup, at Yeq's bound (PAR_Q_BOUND); the LWA fields at
    CARD_CPU_TOL['lwa']."""
    fields = [k for k in ("lwa", "lwa2") if k in want]
    # clength masks nkeff at 1e5, not at threshold_agree's NKEFF_MASK:
    # its Leq2 carries the comparison
    skip = set(fields) | {"Q"} | ({"nkeff"} if "lengths" in want else set())
    keys = [k for k in want if k not in skip]
    facade_vs(label, got, want, keys, what="phase 11",
              against="the unsharded step")
    if "Q" in want:
        field_rel(f"{label} Q", got["Q"], want["Q"], PAR_Q_BOUND,
                  what="phase 11")
    for k in fields:
        field_rel(f"{label} {k}", got[k], want[k], CARD_CPU_TOL["lwa"],
                  what="phase 11")


def sharded_grad_losses(grid, table, mesh):
    """Phase 7's 'keff_lwa auto' and 'clength' losses (grad_losses) of the
    sharded steps on a rank's block, each output replicated over 'x'
    counted once per mesh (parallel.once_per_mesh): the ranks' losses add
    up to phase 7's loss of the whole batch."""
    from xcontour_tpu_torch import parallel as P

    def keff_lwa(t, N):
        o = P.sharded_keff_lwa_pipeline(t, grid, mesh, N=N, lmin="analytic",
                                        table=table)
        return (torch.nansum(o["lwa"] * o["lwa"])
                + torch.nansum(P.once_per_mesh(o["nkeff"], mesh)))

    def clength(t, N):
        o = P.sharded_clength_pipeline(t, grid, mesh, N=CLENGTH_N[0],
                                       table=table)
        return (torch.nansum(P.once_per_mesh(o["lengths"], mesh))
                + finite_sum(P.once_per_mesh(o["Leq2"], mesh)))
    return {"keff_lwa auto": keff_lwa, "clength": clength}


def parallel_adjoints(drive, q, grid, table, mesh):
    """Phase 11(a)'s gradients on the mesh of one: each sharded adjoint
    (sharded_grad_losses) against phase 7's unsharded adjoint on the same
    snapshots, its launches a step equal to the unsharded step's, forward
    and backward ms of both in turns.  Returns ({label: numbers}, the
    sharded paths' drive labels, the unsharded keff_lwa gradient)."""
    res, labels, grads = {}, [], {}
    unsharded = grad_losses(grid, table, LOCAL)
    N = ERA5["N"]
    for label, sloss in sharded_grad_losses(grid, table, mesh).items():
        uloss, kernels = unsharded[label]
        expect = {k: 1 for k in kernels}
        g, counts = {}, {}
        for side, loss in (("unsharded", uloss), ("sharded", sloss)):
            path = f"{'parallel ' if side == 'sharded' else ''}adjoint " \
                f"{label} era5 B={GRAD_ERA5_B}"
            g[side] = drive(path, expect, lambda: adjoint_ms(loss, q, N)[2])
            counts[side] = kernel_counts()
        labels.append(f"parallel adjoint {label} era5 B={GRAD_ERA5_B}")
        # the mesh layout forms clength's weights without G
        want = dict(counts["unsharded"], clength_weights=0)
        _expect(counts["sharded"] == want,
                f"phase 11 adjoint {label}: the sharded step launches "
                f"{counts['sharded']}, the unsharded {counts['unsharded']}")
        share, worst = grad_agree(
            f"phase 11 adjoint {label} era5 sharded (1x1 NCCL mesh) vs "
            "unsharded", g["sharded"], g["unsharded"],
            sides=("sharded", "unsharded"))
        ms = {side: ([], []) for side in g}
        for i in range(PAR_GRAD_REPS + 1):      # the first is a warm-up
            turn = (("unsharded", uloss), ("sharded", sloss))
            for side, loss in (turn if i % 2 == 0 else turn[::-1]):
                f, b, _ = adjoint_ms(loss, q, N)
                if i:
                    ms[side][0].append(f)
                    ms[side][1].append(b)
        med = {side: [statistics.median(v) for v in ms[side]] for side in ms}
        res[label] = dict(
            fwd_ms=med["sharded"][0], bwd_ms=med["sharded"][1],
            unsharded_fwd_ms=med["unsharded"][0],
            unsharded_bwd_ms=med["unsharded"][1], share_within=share,
            worst_rel=worst, launches=counts["sharded"])
        log(f"phase 11 time adjoint {label} era5 {tuple(q.shape)}: sharded "
            f"(1x1 NCCL mesh) forward {med['sharded'][0]:.2f} ms, backward "
            f"{med['sharded'][1]:.2f} ms; unsharded forward "
            f"{med['unsharded'][0]:.2f} ms, backward "
            f"{med['unsharded'][1]:.2f} ms (host clock, median of "
            f"{PAR_GRAD_REPS} in turns); launches a step {counts['sharded']}")
        grads[label] = g["unsharded"]
    return res, labels, grads["keff_lwa auto"]


def parallel_inprocess(dev, drive, q, grid, table):
    """Phase 11(a): an NCCL group of one in this process and a ('cuda',
    (1, 1)) mesh; each sharded function and step against its unsharded
    counterpart at ERA5 width, the launch counts, the sharded adjoints
    (parallel_adjoints) and the sharded composition's cost.  Returns
    (numbers, the forward paths' drive labels, the adjoints', the
    unsharded keff_lwa adjoint's gradient)."""
    import datetime
    import tempfile
    import torch.distributed as dist
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch import parallel as P
    from xcontour_tpu_torch.ops.histogram import weighted_cdf_multi
    from xcontour_tpu_torch.ops.sort import exact_conditional_integral
    from xcontour_tpu_torch.parallel import _comm
    res, labels, errs = {}, [], {}
    N = ERA5["N"]
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(
            "nccl", store=store, rank=0, world_size=1, device_id=dev,
            timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
        try:
            mesh = P.make_mesh(1)
            _expect(mesh.device_type == "cuda"
                    and tuple(mesh.shape) == (1, 1), f"phase 11 mesh {mesh}")
            calls = dict(_comm.CALLS)
            dA = grid.dA
            grdS = P.sharded_squared_gradient(q, grid, mesh)
            errs["squared_gradient"] = par_vs(
                "sharded_squared_gradient (K1 on the halo slab)", grdS,
                xt.squared_gradient(q, grid),
                KERNEL_BOUNDS["squared_gradient"])
            ctr = xt.cal_contours(q, N)
            _expect(torch.equal(P.sharded_contours(q, N, mesh), ctr),
                    "phase 11: the sharded levels differ")
            w = [dA, grdS * dA]
            for a, b, name in zip(
                    P.sharded_weighted_cdf_multi(q, ctr, w, True, mesh),
                    weighted_cdf_multi(q, ctr, w, True), ("area", "grdS")):
                errs[f"weighted_cdf_{name}"] = par_vs(
                    f"sharded_weighted_cdf_multi {name} (K2)", a, b,
                    KERNEL_BOUNDS["weighted_cdf"])
            wb = torch.broadcast_to(dA, q.shape)
            par_vs("sharded_exact_conditional_integral",
                   P.sharded_exact_conditional_integral(q, ctr, wb, True,
                                                        mesh),
                   exact_conditional_integral(q, ctr, wb, True), EXACT_BOUND)
            Q = xt.keff_lwa_pipeline(q, grid, N=N, table=table)["Q"]
            for name, fn, sfn, kw, bound in (
                    ("lwa_lin", xt.local_wave_activity,
                     P.sharded_local_wave_activity, {}, "lwa_lin"),
                    ("lwa_dense", xt.local_wave_activity,
                     P.sharded_local_wave_activity, dict(method="dense"),
                     "lwa_dense"),
                    ("lwa_lin2", xt.local_wave_activity2,
                     P.sharded_local_wave_activity2, {}, "lwa_lin2")):
                errs[name] = par_vs(
                    f"sharded LWA {name}", sfn(q, Q, dA, grid.ydef, mesh,
                                               increase=True, **kw),
                    fn(q, Q, dA, grid.ydef, increase=True, **kw),
                    KERNEL_BOUNDS[bound])
            c121 = xt.cal_contours(q, CLENGTH_N[0])
            errs["contour_lengths"] = par_vs(
                "sharded_contour_lengths N=121 (K7 on slab and halo)",
                P.sharded_contour_lengths(q, c121, grid.ydef, grid.xdef, mesh,
                                          latlon=True),
                xt.contour_lengths(q, c121, grid.ydef, grid.xdef,
                                   latlon=True),
                KERNEL_BOUNDS["contour_lengths"])
            errs["local_lengths"] = par_vs(
                "sharded_local_lengths window 101 stride 10 (K8)",
                P.sharded_local_lengths(q[0], grid.ydef, grid.xdef, mesh,
                                        **LOCAL)[0],
                xt.local_contour_lengths(q[0], grid.ydef, grid.xdef,
                                         **LOCAL)[0],
                KERNEL_BOUNDS["local_lengths"])

            # the sharded steps through drive: every launch count from 0
            kw = dict(N=N, table=table)
            for label, expect, sfn, fn, extra in (
                    ("keff_lwa era5 auto", dict(squared_gradient=1,
                                                weighted_cdf=1, lwa_lin=1),
                     P.sharded_keff_lwa_pipeline, xt.keff_lwa_pipeline, {}),
                    ("keff_lwa era5 dense", dict(squared_gradient=1,
                                                 weighted_cdf=1, lwa_dense=1),
                     P.sharded_keff_lwa_pipeline, xt.keff_lwa_pipeline,
                     dict(lwa_method="dense")),
                    ("lwa era5 auto", dict(weighted_cdf=1, lwa_lin=1,
                                           lwa_lin2=1),
                     P.sharded_lwa_pipeline, xt.lwa_pipeline, {}),
                    ("clength era5 N=121", dict(weighted_cdf=1,
                                                contour_lengths=1),
                     P.sharded_clength_pipeline, xt.clength_pipeline,
                     dict(N=CLENGTH_N[0]))):
                labels.append(f"parallel {label}")
                # the mesh layout forms clength's weights without G; its
                # levels are E's extrema mode reduced over x
                got = drive(f"parallel {label}", expect,
                            lambda: sfn(q, grid, mesh, **dict(kw, **extra)),
                            exact=dict(weighted_cdf=1, clength_weights=0,
                                       contour_levels=1))
                par_step_vs(label, got, fn(q, grid, **dict(kw, **extra)))
            labels.append("parallel local era5")
            drive("parallel local era5",
                  dict(local_lengths=1, window_means=1),
                  lambda: P.sharded_local_lengths(q[0], grid.ydef, grid.xdef,
                                                  mesh, **LOCAL),
                  exact=dict(local_lengths=1, window_means=1,
                             contour_levels=0))
            # the sharded adjoints against phase 7's
            res["adjoint"], grad_labels, adj_grad = parallel_adjoints(
                drive, q[:GRAD_ERA5_B].contiguous(), grid, table, mesh)
            _expect(dict(_comm.CALLS) == calls,
                    "phase 11: the ring of one ran a collective")

            # the cost of the sharded composition, in turns
            for method in ("auto", "dense"):
                sk = dict(kw, lwa_method=method)
                ts, tu = [], []
                for i in range(PAR_REPS):
                    for side in ((ts, tu) if i % 2 == 0 else (tu, ts)):
                        fn = (lambda: P.sharded_keff_lwa_pipeline(
                            q, grid, mesh, **sk)) if side is ts else \
                            (lambda: xt.keff_lwa_pipeline(q, grid, **sk))
                        side.append(cuda_ms(fn, 1))
                ms_s, ms_u = statistics.median(ts), statistics.median(tu)
                # device time a step (torch.profiler), to tell the added
                # device work from the added host time
                dev_s = sum(device_split(lambda: P.sharded_keff_lwa_pipeline(
                    q, grid, mesh, **sk), calls=5).values())
                dev_u = sum(device_split(lambda: xt.keff_lwa_pipeline(
                    q, grid, **sk), calls=5).values())
                res[f"keff_lwa_{method}"] = dict(
                    sharded_ms=ms_s, unsharded_ms=ms_u, ratio=ms_s / ms_u,
                    sharded_device_ms=dev_s, unsharded_device_ms=dev_u)
                log(f"phase 11 time keff_lwa era5 {method}: sharded (1x1 "
                    f"NCCL mesh) {ms_s:.4f} ms, keff_lwa_pipeline "
                    f"{ms_u:.4f} ms, ratio {ms_s / ms_u:.4f} (CUDA events, "
                    f"median of {PAR_REPS} in turns, table reused); device "
                    f"time a step {dev_s:.4f} / {dev_u:.4f} ms "
                    "(torch.profiler)")
        finally:
            dist.destroy_process_group()
    res["errs"] = errs
    return res, labels, grad_labels, adj_grad


def parallel_cli(drive, none, path, base, got, T, tmp):
    """Phase 11(a) through the CLI on phase 10's archive: --mesh 1 and 1x1
    in process (a group of one) against the run without --mesh, and
    --mesh 2 refused on one card."""
    labels = []
    for spec in ("1", "1x1"):
        out = os.path.join(tmp, f"mesh{spec}.nc")
        label = f"parallel cli keff-lwa era5 --mesh {spec}"
        labels.append(label)
        counts = {"squared_gradient": T, "weighted_cdf": 2 * T, "lwa_lin": T,
                  "contour_levels": T}
        rc, _, secs = drive(label, counts, lambda: run_cli(
            base + ["--mesh", spec, "--out", out]), exact=dict(none, **counts))
        _expect(rc == 0, f"phase 11 {label}: rc {rc}")
        mine, _ = nc_tensors(out, got["lwa"].device)
        os.remove(out)
        facade_vs(f"cli --mesh {spec}", mine, got,
                  [k for k in got if k != "lwa"], what="phase 11",
                  against="the run without --mesh")
        field_rel(f"cli --mesh {spec} lwa", mine["lwa"], got["lwa"],
                  CARD_CPU_TOL["lwa"], what="phase 11")
        log(f"phase 11 cli --mesh {spec}: {secs:.3f} s end to end")
    try:
        run_cli(base + ["--mesh", "2", "--out", os.path.join(tmp, "x.nc")])
        raise AssertionError("phase 11: --mesh 2 on one card did not exit")
    except SystemExit as e:
        _expect("2 devices requested, 1 available" in str(e),
                f"phase 11 --mesh 2: {e}")
        log(f"phase 11 cli --mesh 2 refused: '{e}'")
    return labels


def collective_rank(workdir, name):
    """One collective on CUDA tensors of a 2-rank gloo group on one card."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    r, n = dist.get_rank(), dist.get_world_size()
    t = torch.full((4,), float(r + 1), device=dev)
    if name == "all_reduce":
        for op in (dist.ReduceOp.SUM, dist.ReduceOp.MIN, dist.ReduceOp.MAX):
            dist.all_reduce(t.clone(), op=op)
    elif name == "broadcast":
        dist.broadcast(t.clone(), src=0)
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(t.new_empty(4 * n), t)
    elif name == "all_gather":
        dist.all_gather([torch.empty_like(t) for _ in range(n)], t)
    elif name == "gather":
        dist.gather(t, [torch.empty_like(t) for _ in range(n)]
                    if r == 0 else None, dst=0)
    elif name == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(t.new_empty(4), t.repeat(n))
    elif name == "send_recv":
        if r == 0:
            dist.send(t, 1)
        else:
            dist.recv(torch.empty_like(t), 0)
    elif name == "batch_isend_irecv":
        ops = [dist.P2POp(dist.isend, t, (r + 1) % n),
               dist.P2POp(dist.irecv, torch.empty_like(t), (r - 1) % n)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    torch.cuda.synchronize()
    with open(os.path.join(workdir, f"ok{r}"), "w") as f:
        f.write("ok")


def collective_support(tmp):
    """{collective: 'ok' or why not} for gloo on CUDA tensors, each in its
    own 2-rank launch (an unsupported one may abort its processes)."""
    from concurrent.futures import ThreadPoolExecutor
    from xcontour_tpu_torch.parallel.launch import run_ranks
    me = os.path.abspath(__file__)

    def one(name):
        d = os.path.join(tmp, f"coll_{name}")
        try:
            run_ranks(f"{me}:collective_rank", 2, d, args=[name],
                      timeout=PAR_TIMEOUT_S)
            return name, "ok"
        except (RuntimeError, TimeoutError) as e:
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            why = next((ln for ln in reversed(lines)
                        if "Error" in ln or "what()" in ln), lines[-1])
            return name, "no: " + why.strip()[:160]
    with ThreadPoolExecutor(len(PAR_COLLECTIVES)) as pool:
        return dict(pool.map(one, PAR_COLLECTIVES))


def parallel_rank(workdir, spec):
    """Phase 11(b) on one rank of a gloo group whose tensors live on the
    one card: the sharded keff_lwa step on its block of B = PAR_B ERA5
    snapshots, the sharded lengths (K7) and windowed lengths (K8); saves
    its blocks, launch counts and times."""
    import torch.distributed as dist
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch import parallel as P
    from xcontour_tpu_torch.kernels import _build
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    lib = _build.library_path()
    _expect(lib.exists(), f"phase 11 rank: {lib.name} is not built")
    records = kernel_records()
    b, x = (int(v) for v in spec.split("x"))
    mesh = P.make_mesh(x_size=x)
    lat, lon, q = par_inputs()
    grid = xt.from_latlon(lat, lon, device=dev)
    sh = P.shard_batch_spec(mesh, 3)
    qb = torch.as_tensor(np.ascontiguousarray(sh.block(q))).to(dev)
    table = P.replicated_table(xt.cal_area_eqCoord_table_hist(
        grid.fluid_mask(), grid.ydef, grid.dA, increase=True, lt=True), mesh)
    for r in records:
        r.launches = 0
    out = P.sharded_keff_lwa_pipeline(qb, grid, mesh, N=ERA5["N"],
                                      table=table)
    c121 = P.sharded_contours(qb, CLENGTH_N[0], mesh)
    L = P.sharded_contour_lengths(qb, c121, grid.ydef, grid.xdef, mesh,
                                  latlon=True)
    W = P.sharded_local_lengths(qb[0], grid.ydef, grid.xdef, mesh,
                                **LOCAL)[0]
    torch.cuda.synchronize()
    counts = {r.name: r.launches for r in records}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        P.sharded_keff_lwa_pipeline(qb, grid, mesh, N=ERA5["N"], table=table)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    keep = {k: out[k] for k in ("contour", "intArea", "intgrdS", "Yeq",
                                "Lmin", "Leq2", "nkeff", "Q", "lwa")}
    grads = parallel_rank_grads(mesh, q, grid, table) \
        if spec in PAR_GRAD_MESHES else {}
    np.savez(os.path.join(workdir, f"out{dist.get_rank()}.npz"),
             coords=np.array(sh.coords), lengths=L.cpu().numpy(),
             local=W.cpu().numpy(),
             **{k: v.cpu().numpy() for k, v in keep.items()},
             **{k: v for k, v in grads.items() if k.startswith("grad_")})
    # the rank measures windows (K8) when its block of window rows is not
    # empty
    Wy = (ERA5["nlat"] - LOCAL["window"]) // LOCAL["stride"] + 1
    windows = sh.coords[1] * -(-Wy // x) < Wy
    with open(os.path.join(workdir, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(dict(counts=counts, step_s=times, windows=windows,
                       adjoint={k: v for k, v in grads.items()
                                if not k.startswith("grad_")}), f)


def headline_field():
    """(lat, lon, the headline's first snapshot), on the host."""
    lat, lon, pv = make_pv(HEADLINE["B"], HEADLINE["nlat"], HEADLINE["nlon"],
                           100)
    return lat, lon, np.ascontiguousarray(pv[0])


def parallel_rank_grads(mesh, q, grid, table):
    """Phase 11(b)'s gradients on one rank: the sharded keff_lwa adjoint
    on the rank's block of the first GRAD_ERA5_B snapshots (launch counts
    of one step, forward and backward ms of PAR_GRAD_REPS after a warm-up)
    and the windowed lengths' on its columns of the headline snapshot.
    Returns {'grad_keff_lwa', 'grad_local': the blocks' gradients, and the
    counts and times}."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch import parallel as P
    dev = torch.device("cuda", 0)
    sh = P.shard_batch_spec(mesh, 3)
    qb = torch.as_tensor(np.ascontiguousarray(
        sh.block(q[:GRAD_ERA5_B]))).to(dev)
    loss = sharded_grad_losses(grid, table, mesh)["keff_lwa auto"]
    for r in kernel_records():
        r.launches = 0
    fwd, bwd = [], []
    for i in range(PAR_GRAD_REPS + 1):          # the first is a warm-up
        f, b, g = adjoint_ms(loss, qb, ERA5["N"])
        if i == 0:
            counts = kernel_counts()
        else:
            fwd.append(f)
            bwd.append(b)
    hlat, hlon, hq = headline_field()
    hgrid = xt.from_latlon(hlat, hlon, device=dev)
    fb = torch.as_tensor(np.ascontiguousarray(
        P.shard_batch_spec(mesh, 2).block(hq))).to(dev).requires_grad_()
    before = kernel_counts()["local_lengths"]
    L = P.sharded_local_lengths(fb, hgrid.ydef, hgrid.xdef, mesh, **LOCAL)[0]
    gl, = torch.autograd.grad(torch.nansum(P.once_per_mesh(L, mesh)), fb)
    torch.cuda.synchronize()
    return dict(grad_keff_lwa=g.cpu().numpy(), grad_local=gl.cpu().numpy(),
                counts=counts, fwd_ms=fwd, bwd_ms=bwd,
                local_launches=kernel_counts()["local_lengths"] - before)


def par_inputs():
    """(lat, lon, q): PAR_B ERA5 snapshots, the make_pv steps of seeds 0,
    1, ... (the phases' era_steps), on the host."""
    steps = [make_pv(ERA5["B"], ERA5["nlat"], ERA5["nlon"], seed)
             for seed in range(PAR_B // ERA5["B"])]
    return steps[0][0], steps[0][1], np.concatenate([s[2] for s in steps])


def parallel_ranks(dev, era_q, era_grid, table, tmp, adj_grad):
    """Phase 11(b): 2 and 4 gloo ranks on the one card; their joined
    results against the unsharded step on the card; each rank's launch
    counts and step time (ranks share the card and gloo moves the bytes
    through the host: not a scaling figure); on PAR_GRAD_MESHES the joined
    keff_lwa adjoint's gradient against ``adj_grad`` (the unsharded one on
    the same snapshots) and the windowed lengths' against the unsharded
    one."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.parallel.launch import run_ranks
    res = {}
    q = torch.cat([era_q[i] for i in range(PAR_B // ERA5["B"])])
    want = xt.keff_lwa_pipeline(q, era_grid, N=ERA5["N"], table=table)
    c121 = xt.cal_contours(q, CLENGTH_N[0])
    want_L = xt.contour_lengths(q, c121, era_grid.ydef, era_grid.xdef,
                                latlon=True)
    me = os.path.abspath(__file__)
    for spec in PAR_MESHES:
        b, x = (int(v) for v in spec.split("x"))
        d = os.path.join(tmp, f"mesh{spec}")
        t0 = time.perf_counter()
        run_ranks(f"{me}:parallel_rank", b * x, d, args=[spec],
                  timeout=PAR_TIMEOUT_S)
        secs = time.perf_counter() - t0
        blocks = [dict(np.load(os.path.join(d, f"out{r}.npz")))
                  for r in range(b * x)]
        info = [json.load(open(os.path.join(d, f"rank{r}.json")))
                for r in range(b * x)]
        at = {tuple(int(c) for c in blk.pop("coords")): blk
              for blk in blocks}
        got = {}
        for k in blocks[0]:
            if k == "local" or k.startswith("grad_"):
                continue
            rows = []
            for i in range(b):
                parts = [at[i, j][k] for j in range(x)]
                if k == "lwa":
                    rows.append(np.concatenate(parts, axis=-1))
                else:
                    for p in parts[1:]:
                        _expect(np.array_equal(p, parts[0], equal_nan=True),
                                f"phase 11 {spec}: {k} differs over x")
                    rows.append(parts[0])
            got[k] = torch.as_tensor(np.concatenate(rows)).to(dev)
        lengths = got.pop("lengths")
        par_step_vs(f"ranks {spec} keff_lwa era5 B={PAR_B}", got,
                    {k: want[k] for k in got})
        par_vs(f"ranks {spec} sharded_contour_lengths N=121", lengths,
               want_L, KERNEL_BOUNDS["contour_lengths"])
        for i in range(b):
            s = i * (PAR_B // b)
            par_vs(f"ranks {spec} sharded_local_lengths snapshot {s}",
                   torch.as_tensor(at[i, 0]["local"]).to(dev),
                   xt.local_contour_lengths(q[s], era_grid.ydef,
                                            era_grid.xdef, **LOCAL)[0],
                   KERNEL_BOUNDS["local_lengths"])
        counts = [r["counts"] for r in info]
        for r, c in enumerate(counts):
            short = [k for k in ("squared_gradient", "weighted_cdf",
                                 "lwa_lin", "contour_lengths")
                     + (("local_lengths",) if info[r]["windows"] else ())
                     if c[k] == 0]
            _expect(not short, f"phase 11 {spec} rank {r}: {short} not "
                    f"launched ({c})")
            # E's extrema mode for the keff_lwa step's levels and for the
            # lengths' levels
            _expect(c["contour_levels"] == 2, f"phase 11 {spec} rank {r}: "
                    f"{c['contour_levels']} contour_levels launches, not 2")
        step_ms = [1e3 * statistics.median(r["step_s"]) for r in info]
        res[spec] = dict(launch_s=secs, counts=counts, step_ms=step_ms)
        if spec in PAR_GRAD_MESHES:
            res[spec]["adjoint"] = rank_grads_vs(spec, at, info, b, x,
                                                 adj_grad, dev)
        log(f"phase 11 ranks {spec}: {b * x} gloo ranks on one card in "
            f"{secs:.1f} s; launches per rank {counts}; sharded keff_lwa "
            f"step per rank {[round(v, 2) for v in step_ms]} ms (host clock, "
            "ranks share the card and gloo moves the bytes through the "
            "host: not a scaling figure)")
    return res


def rank_grads_vs(spec, at, info, b, x, adj_grad, dev):
    """Phase 11(b)'s joined gradients against the unsharded card
    gradients (grad_agree); the ranks' launches and times logged."""
    import xcontour_tpu_torch as xt
    got = np.concatenate([np.concatenate([at[i, j]["grad_keff_lwa"]
                                          for j in range(x)], axis=-1)
                          for i in range(b)])
    share, worst = grad_agree(
        f"phase 11 ranks {spec} adjoint keff_lwa auto era5 joined vs "
        "unsharded", torch.as_tensor(got), adj_grad,
        sides=("sharded", "unsharded"))
    hlat, hlon, hq = headline_field()
    hgrid = xt.from_latlon(hlat, hlon, device=dev)
    f = torch.as_tensor(hq).to(dev).requires_grad_()
    L = xt.local_contour_lengths(f, hgrid.ydef, hgrid.xdef, **LOCAL)[0]
    want, = torch.autograd.grad(torch.nansum(L), f)
    for i in range(b):                  # each batch row: the whole field
        gl = np.concatenate([at[i, j]["grad_local"] for j in range(x)],
                            axis=-1)
        local = grad_agree(
            f"phase 11 ranks {spec} windowed lengths headline batch row {i} "
            "joined vs unsharded", torch.as_tensor(gl), want,
            sides=("sharded", "unsharded"))
    adj = [r["adjoint"] for r in info]
    for r, a in enumerate(adj):
        short = [k for k in ("squared_gradient", "weighted_cdf", "lwa_lin")
                 if a["counts"][k] == 0]
        _expect(not short, f"phase 11 {spec} rank {r} adjoint: {short} not "
                f"launched ({a['counts']})")
    _expect(sum(a["local_launches"] for a in adj) > 0,
            f"phase 11 {spec}: no rank launched K8 for the windowed lengths")
    fwd = [statistics.median(a["fwd_ms"]) for a in adj]
    bwd = [statistics.median(a["bwd_ms"]) for a in adj]
    log(f"phase 11 time ranks {spec} adjoint keff_lwa auto era5 "
        f"B={GRAD_ERA5_B}: forward per rank {[round(v, 2) for v in fwd]} ms, "
        f"backward {[round(v, 2) for v in bwd]} ms (host clock, median of "
        f"{PAR_GRAD_REPS}; ranks share the card and gloo moves the bytes "
        f"through the host); launches a step per rank "
        f"{[a['counts'] for a in adj]}; K8 launches for the windowed "
        f"lengths {[a['local_launches'] for a in adj]}")
    return dict(share_within=share, worst_rel=worst,
                local_share_within=local[0], local_worst_rel=local[1],
                fwd_ms=fwd, bwd_ms=bwd)


def parallel_phase(dev, drive, era_steps, era_grid):
    """Phase 11: the sharded path on the card, (a) in process and (b) over
    gloo ranks, forward and gradients.  Returns (numbers, the forward
    paths' drive labels, the sharded adjoints')."""
    import tempfile
    import xcontour_tpu_torch as xt
    table = xt.cal_area_eqCoord_table_hist(
        era_grid.fluid_mask(), era_grid.ydef, era_grid.dA, increase=True,
        lt=True)
    res, labels, grad_labels, adj_grad = parallel_inprocess(
        dev, drive, era_steps[0], era_grid, table)
    with tempfile.TemporaryDirectory() as tmp:
        support = collective_support(tmp)
        res["gloo_cuda"] = support
        log(f"phase 11 gloo on CUDA tensors (torch {torch.__version__}): "
            + ", ".join(f"{k} {v}" for k, v in support.items()))
        used = ("all_reduce", "all_gather_into_tensor", "broadcast")
        _expect(all(support[k] == "ok" for k in used), f"phase 11: gloo "
                f"refuses CUDA tensors in one of {used}, which the port's "
                "collectives use")
        res["ranks"] = parallel_ranks(dev, era_steps, era_grid, table, tmp,
                                      adj_grad)
    return res, labels, grad_labels


# -- phase 12: the structure probes behind kernel_rooflines ----------------

def same_bits(a, b):
    """Equal bits, NaN for NaN (whatever its payload)."""
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    if a.dtype != b.dtype:
        return False
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    bits = torch.int32 if a.element_size() == 4 else torch.int64
    return torch.equal(torch.where(nan, zero, a).view(bits),
                       torch.where(nan, zero, b).view(bits))


def probe_against(name, label, got, want, what):
    """Hold got against want within KERNEL_BOUNDS[name] of want's largest
    magnitude; returns the max abs error."""
    err, rel = rel_err(got, want)
    bound = KERNEL_BOUNDS[name]
    ok = rel <= bound
    log(f"phase 12 check {name} {label} {what}: max_abs_err {err:.6g} "
        f"rel {rel:.3e} bound {bound:g} {'OK' if ok else 'FAIL'}")
    _expect(ok, f"{name} {label} {what}: disagrees with its plain version")
    return err


def run_twice(name, label, fn):
    """fn's output, which a second run must repeat bit for bit."""
    got = fn()
    _expect(same_bits(fn(), got), f"{name} {label}: two runs differ")
    return got


def probe_checks(label, q, grid, N, n_lengths):
    """P1-P4 against their plain versions on the same CUDA tensors, at the
    inputs their kernels get on the main path: K3's (q, keff_lwa_pipeline's
    Q, the composed weight), K2's (q, the edges of N levels, dA and
    |grad q|^2 dA, NaN weights zeroed), also with values below the first
    edge, at and above the top one and a NaN weight (q's NaN patch gives
    NaN values), K7's
    (lat-lon, levels at each count of n_lengths) and K1's q.  P1 within
    its bound of the float32 plain version; P2 and P3 of the float64 one,
    two runs bit for bit; P4 bit for bit.  Returns {name: max abs error}
    (P3's at n_lengths[0])."""
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.diagnostics.lwa import nanmax
    from xcontour_tpu_torch.kernels import probes, stencil
    from xcontour_tpu_torch.ops import histogram, stencil as ops_stencil

    B = q.shape[0]
    errs = {}

    def f64(*ts):
        return [t.double() for t in ts]

    def against(name, got, want, what):
        return probe_against(name, label, got, want, what)

    def twice(name, fn):
        return run_twice(name, label, fn)

    Q = xt.keff_lwa_pipeline(q, grid, N=N)["Q"].contiguous()
    W = (grid.dA / nanmax(grid.dA) * grid.dA).contiguous()
    name = probes.KERNEL_LWA.name
    errs[name] = against(name, probes.lwa_structure(q, Q, W),
                         probes.lwa_structure_plain(q, Q, W),
                         f"{tuple(q.shape)} against float32 plain")

    dy, dx = ops_stencil._spacing(grid, q.dtype)
    grdS = stencil.squared_gradient_plain(q, (1.0 / dx).contiguous(),
                                          (1.0 / dy).contiguous(),
                                          periodic_x=grid.periodic_x)
    e = histogram._edges(xt.cal_contours(q, N))[1].contiguous()
    v = q.reshape(B, -1).contiguous()
    # K2 adds no NaN weight (|grad q|^2 is NaN around q's NaN patch); P2
    # would carry one to its whole batch element, so they are zeroed here
    w = torch.nan_to_num(torch.stack(
        [torch.broadcast_to(grid.dA, q.shape).reshape(B, -1),
         (grdS * grid.dA).reshape(B, -1)], 1), nan=0.0).contiguous()
    v2, w2 = v.clone(), w.clone()
    v2[0, :1000] = e[0, 0] - 1.0
    v2[0, 1000:2000] = e[0, -1]
    v2[0, 2000:3000] = e[0, -1] + 1.0
    w2[1, 0, 5] = float("nan")
    name = probes.KERNEL_HIST.name
    for what, vv, ww in (("", v, w), (" edge cases", v2, w2)):
        got = twice(name, lambda: probes.hist_structure(vv, e, ww))
        err = against(name, got, probes.hist_structure_plain(*f64(vv, e, ww)),
                      f"N={N}{what} against float64 plain")
        errs.setdefault(name, err)
    _expect(bool(torch.isnan(got[1])) and not bool(torch.isnan(got[0])),
            f"{name} {label}: the NaN weight did not propagate to its "
            "element alone")

    yc = torch.deg2rad(grid.ydef).contiguous()
    xc = torch.deg2rad(grid.xdef).contiguous()
    name = probes.KERNEL_LENGTH.name
    for n in n_lengths:
        lev = xt.cal_contours(q, n).contiguous()
        got = twice(name, lambda: probes.length_structure(q, lev, yc, xc))
        err = against(name, got, probes.length_structure_plain(
            *f64(q, lev, yc, xc), chunk=2), f"N={n} against float64 plain")
        errs.setdefault(name, err)

    name = probes.KERNEL_COPY.name
    ok = same_bits(probes.scaled_copy(q), probes.scaled_copy_plain(q))
    log(f"phase 12 probe {name} {label} {tuple(q.shape)}: bit for bit "
        f"{'OK' if ok else 'FAIL'}")
    _expect(ok, f"{name} {label}: differs from q * {probes.SCALE}")
    errs[name] = 0.0
    return errs


def timed_checks(label, x, N):
    """The calls kernel_rooflines times, each held against its plain
    version on the inputs it times them on (utils.roofline.roofline_inputs
    ``x``): K1 within its bound and P4 bit for bit on the stack past the
    L2; K2 and K3 within their bounds of their float32 plain versions, P1
    of its own; K7 (within its bound), P2 and P3 of their float64 plain
    versions, two runs bit for bit."""
    from xcontour_tpu_torch.kernels import hist, length, lwa, probes, stencil

    def f64(*ts):
        return [t.double() for t in ts]

    qs, rdx, rdy = x["qs"], x["rdx"], x["rdy"]
    q, Q, W = x["q"], x["Q"], x["W"]
    v, e, w = x["vals"], x["edges"], x["wts"]
    lev, yc, xc = x["levels"], x["yc"], x["xc"]
    stack = f"{tuple(qs.shape)} stack"
    probe_against("squared_gradient", label,
                  stencil.squared_gradient(qs, rdx, rdy, periodic_x=True),
                  stencil.squared_gradient_plain(qs, rdx, rdy,
                                                 periodic_x=True), stack)
    name = probes.KERNEL_COPY.name
    ok = same_bits(probes.scaled_copy(qs), probes.scaled_copy_plain(qs))
    log(f"phase 12 check {name} {label} {stack}: bit for bit "
        f"{'OK' if ok else 'FAIL'}")
    _expect(ok, f"{name} {label}: differs from q * {probes.SCALE}")
    probe_against("weighted_cdf", label, hist.weighted_cdf(v, e, w),
                  hist.weighted_cdf_plain(v, e, w), f"N={N}")
    name = probes.KERNEL_HIST.name
    probe_against(name, label,
                  run_twice(name, label,
                            lambda: probes.hist_structure(v, e, w)),
                  probes.hist_structure_plain(*f64(v, e, w)),
                  f"N={N} against float64 plain")
    probe_against("lwa_lin", label, lwa.lwa_lin(q, Q, W, increase=True),
                  lwa.lwa_lin_plain(q, Q, W, increase=True),
                  f"{tuple(q.shape)}")
    name = probes.KERNEL_LWA.name
    probe_against(name, label, probes.lwa_structure(q, Q, W),
                  probes.lwa_structure_plain(q, Q, W), f"{tuple(q.shape)}")
    probe_against("contour_lengths", label,
                  run_twice("contour_lengths", label,
                            lambda: length.contour_lengths(q, lev, yc, xc,
                                                           latlon=True)),
                  length.contour_lengths_plain(*f64(q, lev, yc, xc),
                                               latlon=True, chunk=2),
                  f"N={N} against float64 plain")
    name = probes.KERNEL_LENGTH.name
    probe_against(name, label,
                  run_twice(name, label,
                            lambda: probes.length_structure(q, lev, yc, xc)),
                  probes.length_structure_plain(*f64(q, lev, yc, xc),
                                                chunk=2),
                  f"N={N} against float64 plain")


def roofline_phase(dev, drive, card, runs):
    """kernel_rooflines through the port at each (label, shape, q, grid)
    of ``runs``, on the last level of q (no NaN patch) on the grid's
    coordinates: first every call it times against its plain version on
    the same inputs (timed_checks), then kernel_rooflines as a path of its
    own (every launch count at 0 before it): K1, K2, K3, K7 and P1-P4
    launched; one line per kernel with the card.  Returns {label:
    kernel_rooflines' dict}."""
    from xcontour_tpu_torch.kernels import hist, length, lwa, probes, stencil
    from xcontour_tpu_torch.utils.roofline import roofline_inputs
    pairs = dict(zip(ROOFLINE_KEYS, (
        (stencil.KERNEL, probes.KERNEL_COPY), (hist.KERNEL, probes.KERNEL_HIST),
        (lwa.KERNEL_LIN, probes.KERNEL_LWA),
        (length.KERNEL_LENGTHS, probes.KERNEL_LENGTH))))
    expect = {r.name: 1 for pair in pairs.values() for r in pair}
    roof = {}
    for label, shape, q, grid in runs:
        lat, lon = grid.ydef.cpu().numpy(), grid.xdef.cpu().numpy()
        vor = q[-1].cpu().numpy()
        timed_checks(label, roofline_inputs(lat, lon, vor, shape["B"],
                                            shape["N"], device=dev),
                     shape["N"])
        roof[label] = res = drive(
            f"kernel_rooflines {label}", expect,
            lambda: kernel_rooflines(lat, lon, vor, batch=shape["B"],
                                     N=shape["N"], device=dev))
        _expect(res["device"] == torch.cuda.get_device_name(0),
                f"kernel_rooflines ran on {res['device']}")
        for key, (kern, probe) in pairs.items():
            r = res[key]
            lib = (f", torch.mul {r['library_ms']:.4f} ms"
                   if "library_ms" in r else "")
            log(f"phase 12 roofline {label} {key} {res['shape']} N={res['N']}"
                f": {kern.name} {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                f"ms ({r['bound_by']}), {r['pct_of_bound']:.2f}% of bound; "
                f"{probe.name} {r['probe_ms']:.4f} ms, bound "
                f"{r['probe_bound_ms']:.4f} ms ({r['probe_bound_by']}), "
                f"{r['probe_pct_of_bound']:.2f}% of bound{lib}; kernel at "
                f"{r['pct_of_structure_ceiling']:.2f}% of its structure "
                f"ceiling | {card}")
    log(f"phase 12 roofline json {json.dumps(roof)}")
    return roof


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run", file=sys.stderr)
        return 1
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.kernels import (_build, boxcount, decode, gradw,
                                            hist, length, lwa, stencil)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = list(kernel_records())

    # 1. the card
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"phase 2 build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    name = ""
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line or "Used" in line:
            log(f"  ptxas {name[-48:]}: {line.strip()}")

    # set-up: data for every phase, made on the host in bulk
    t0 = time.perf_counter()
    era = [make_pv(ERA5["B"], ERA5["nlat"], ERA5["nlon"], seed)
           for seed in range(STREAM_STEPS + 1)]
    era_grid = xt.from_latlon(era[0][0], era[0][1], device=dev)
    era_steps = [torch.as_tensor(pv).to(dev) for _, _, pv in era]
    del era
    local_q = torch.as_tensor(make_pv(LOCAL_B, ERA5["nlat"], ERA5["nlon"],
                                      STREAM_STEPS + 1)[2]).to(dev)
    hlat, hlon, hpv = make_pv(HEADLINE["B"], HEADLINE["nlat"],
                              HEADLINE["nlon"], 100)
    head_grid = xt.from_latlon(hlat, hlon, device=dev)
    head_q = torch.as_tensor(hpv).to(dev)
    tlat, tlon, tpv = make_pv(TALL["B"], TALL["nlat"], TALL["nlon"], 200)
    tall_grid = xt.from_latlon(tlat, tlon, device=dev)
    tall_q = torch.as_tensor(tpv).to(dev)
    lv, lb = lape_data(LAPE["B"])
    lape_grid = xt.from_xz(lv["Z"], lv["XC"], lv["hFacC"], mask=lv["maskC"],
                           device=dev)
    lape_q = torch.as_tensor(lb).to(dev)
    lape_mask = torch.as_tensor(lv["maskC"]).to(dev)
    torch.cuda.synchronize()
    log(f"set-up: data made and staged in {time.perf_counter() - t0:.2f} s")

    # 3. kernel checks at the paths' shapes
    cases, errs = {}, {}
    for label, grid, q, N in (("era5", era_grid, era_steps[0], ERA5["N"]),
                              ("headline", head_grid, head_q, HEADLINE["N"])):
        cases[label] = kernel_cases(q, grid, N)
        for name, (kern, plain, _) in cases[label].items():
            err = check_kernel(label, name, kern, plain, tuple(q.shape))
            if label == "era5":
                errs[name] = err
    # made again for phase 6: held until then they would count in phase 4's
    # peak memory
    for name, (kern, plain, _) in k2_cases(era_steps[0], era_grid,
                                           ERA5["N"]).items():
        errs[name] = check_kernel("era5", "weighted_cdf", kern, plain,
                                  name[len("weighted_cdf_"):])
    cases["tall"] = tall_cases(tall_q, tall_grid, TALL["N"])
    for name, (kern, plain, _) in cases["tall"].items():
        errs[name] = check_kernel("tall", name, kern, plain,
                                  tuple(tall_q.shape))
    cases["lape"] = lape_cases(lape_q, lape_grid, lape_mask, LAPE["N"])
    for name, (kern, plain, _) in cases["lape"].items():
        check_kernel("lape", name, kern, plain, tuple(lape_q.shape))

    # the kernels' other modes, at the headline shape (the main paths run
    # periodic x, 'extend' walls, increase=True)
    q = head_q[:4].clone()
    q[0, 1, 5] = float("nan")          # the 'reflect' walls read row 1
    for name, kern, plain, bound in variant_cases(q, head_grid):
        _, rel = rel_err(kern(), plain())
        ok = rel <= bound
        log(f"phase 3 variant {name}: rel {rel:.3e} bound {bound:g} "
            f"{'OK' if ok else 'FAIL'}")
        _expect(ok, f"{name} disagrees with its plain version")
    queue3_checks(dev)
    odd_shape_checks(dev)

    # K7 and K8 against their plain versions in float64, and the tie rule
    cases["length"] = length_cases(era_steps[0], era_grid, head_q, local_q)
    for name, (bound_key, kern, plain, plain64, _, _) in \
            cases["length"].items():
        errs[name] = check_length_kernel(name, bound_key, kern, plain, plain64)
    tie_checks(dev)
    k8_batch_checks(local_q, era_grid)
    rolling_checks(local_q, errs)
    limit_checks(dev, era_steps[0], era_grid)
    decode_checks(dev, errs)
    boxcount_checks(head_q, head_grid, HEADLINE["N"], errs)
    clength_weights_checks(era_steps[0], era_grid, errs)
    contour_levels_checks(contour_levels_cases(local_q, head_q, lape_q),
                          errs)

    # 4. the paths, through the entry points a user calls
    totals = {r.name: 0 for r in records}
    peaks, path_counts = {}, {}

    def drive(label, expect, fn, exact=None):
        """Run one path with every launch count at 0; fail unless each
        kernel in ``expect`` reached its count, and each in ``exact`` hit
        its count exactly."""
        for r in records:
            r.launches = 0
        torch.cuda.reset_peak_memory_stats()
        result = fn()
        torch.cuda.synchronize()
        counts = {r.name: r.launches for r in records}
        path_counts[label] = counts
        peaks[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        for k, c in counts.items():
            totals[k] += c
        log(f"phase 4 launches {label}: {counts}, peak {peaks[label]:.3f} GiB")
        short = {k: c for k, c in expect.items() if counts[k] < c}
        _expect(not short, f"{label}: kernels launched fewer times than "
                           f"the path runs them: {short} (counts {counts})")
        off = {k: c for k, c in (exact or {}).items() if counts[k] != c}
        _expect(not off, f"{label}: launch counts {counts} differ from "
                         f"{off}")
        return result

    def era_table():
        return xt.cal_area_eqCoord_table_hist(
            era_grid.fluid_mask(), era_grid.ydef, era_grid.dA,
            increase=True, lt=True)

    S, SE = STREAM_STEPS, STREAM_STEPS + 1
    rates = {}
    eshape = (ERA5["B"], ERA5["nlat"], ERA5["nlon"])
    for method, lwa_k in (("auto", "lwa_lin"), ("dense", "lwa_dense")):
        def run(method=method):
            table = era_table()
            fn = lambda q, t: xt.keff_lwa_pipeline(
                q, era_grid, N=ERA5["N"], lwa_method=method, table=t)
            outs, times = timed_steps(lambda q: fn(q, table), era_steps[:S])
            own, own_t = timed_steps(lambda q: fn(q, None), era_steps[S:])
            return outs + own, times, own_t
        # K2: one launch per step and one per table build; E one a step
        outs, times, own_t = drive(
            f"keff_lwa era5 {method}",
            {"squared_gradient": SE, "weighted_cdf": SE, lwa_k: SE}, run,
            exact={"weighted_cdf": SE + 2, "contour_levels": SE})
        for i, out in enumerate(outs):
            check_step(out, ERA5["B"], ERA5["nlat"], ERA5["N"],
                       f"keff_lwa era5 {method} step {i}")
        rates[f"keff_lwa_era5_{method}"] = (ERA5["B"] / statistics.median(times),
                                            ERA5["B"] / own_t[0], times)
        log(f"phase 4 keff_lwa era5 {method}: {S} steps with table reuse, "
            f"step s {[round(t, 5) for t in times]}, own-table step "
            f"{own_t[0]:.5f} s: checks OK")
    out = drive("keff_lwa era5 own-table step",
                {"squared_gradient": 1, "lwa_lin": 1},
                lambda: xt.keff_lwa_pipeline(era_steps[0], era_grid,
                                             N=ERA5["N"]),
                exact={"weighted_cdf": 2, "contour_levels": 1})
    check_step(out, ERA5["B"], ERA5["nlat"], ERA5["N"],
               "keff_lwa era5 own-table step")
    head_table = xt.cal_area_eqCoord_table_hist(
        head_grid.fluid_mask(), head_grid.ydef, head_grid.dA,
        increase=True, lt=True)
    for method, lwa_k in (("auto", "lwa_lin"), ("dense", "lwa_dense")):
        outs, times = drive(
            f"keff_lwa headline {method}",
            {"squared_gradient": 5, "weighted_cdf": 5, lwa_k: 5},
            lambda method=method: timed_steps(
                lambda q: xt.keff_lwa_pipeline(q, head_grid, N=HEADLINE["N"],
                                               lwa_method=method,
                                               table=head_table),
                [head_q] * 5), exact={"contour_levels": 5})
        for out in outs:
            check_step(out, HEADLINE["B"], HEADLINE["nlat"], HEADLINE["N"],
                       f"keff_lwa headline {method}")
        rates[f"keff_lwa_headline_{method}"] = (
            HEADLINE["B"] / statistics.median(times[1:]), None, times)
        log(f"phase 4 keff_lwa headline {method}: step s "
            f"{[round(t, 5) for t in times]}: checks OK")

    # lwa_pipeline at ERA5, the production loop's form (metric='dy'):
    # 'auto' runs K3 and K5 once a step, 'dense' K4 twice (LWA and LWA2)
    for method, expect in (("auto", {"lwa_lin": SE, "lwa_lin2": SE}),
                           ("dense", {"lwa_dense": 2 * SE})):
        def run(method=method):
            table = era_table()
            fn = lambda q, t: xt.lwa_pipeline(q, era_grid, N=ERA5["N"],
                                              metric="dy", lwa_method=method,
                                              table=t)
            outs, times = timed_steps(lambda q: fn(q, table), era_steps[:S])
            own, own_t = timed_steps(lambda q: fn(q, None), era_steps[S:])
            return outs + own, times, own_t
        outs, times, own_t = drive(f"lwa era5 {method}",
                                   dict(expect, weighted_cdf=SE), run,
                                   exact={"weighted_cdf": SE + 2,
                                          "contour_levels": SE})
        for i, out in enumerate(outs):
            check_lwa_step(out, eshape, ERA5["N"], -90.0, 90.0,
                           f"lwa era5 {method} step {i}")
        rates[f"lwa_era5_{method}"] = (ERA5["B"] / statistics.median(times),
                                       ERA5["B"] / own_t[0], times)
        log(f"phase 4 lwa era5 {method}: {S} steps with table reuse, step s "
            f"{[round(t, 5) for t in times]}, own-table step {own_t[0]:.5f} "
            f"s: checks OK")

    # the split (era5.lwa_split): K4 once for LWA and once for LWA2, both
    # halves a launch, no K3 or K5
    def run_split():
        table = era_table()
        return timed_steps(
            lambda q: xt.lwa_pipeline(q, era_grid, N=ERA5["N"],
                                      part="split", table=table),
            era_steps[:S])
    outs, times = drive("lwa era5 split", {"weighted_cdf": S}, run_split,
                        exact=dict(lwa_dense=2 * S, lwa_lin=0, lwa_lin2=0,
                                   weighted_cdf=S + 1, contour_levels=S))
    for i, out in enumerate(outs):
        check_split_step(out, eshape, ERA5["N"], f"lwa era5 split step {i}")
    rates["lwa_era5_split"] = (ERA5["B"] / statistics.median(times), None,
                               times)
    log(f"phase 4 lwa era5 split: {S} steps with table reuse, step s "
        f"{[round(t, 5) for t in times]}: checks OK")

    hshape = (HEADLINE["B"], HEADLINE["nlat"], HEADLINE["nlon"])
    outs, times = drive(
        "lwa headline upper", {"weighted_cdf": 5, "lwa_dense": 10},
        lambda: timed_steps(
            lambda q: xt.lwa_pipeline(q, head_grid, N=HEADLINE["N"],
                                      part="upper", table=head_table),
            [head_q] * 5), exact={"contour_levels": 5})
    for out in outs:
        check_lwa_step(out, hshape, HEADLINE["N"], -90.0, 90.0,
                       "lwa headline upper")
    rates["lwa_headline_upper"] = (HEADLINE["B"] / statistics.median(times[1:]),
                                   None, times)
    log(f"phase 4 lwa headline upper: step s {[round(t, 5) for t in times]}: "
        f"checks OK")

    lshape = (LAPE["B"], LAPE["nz"], LAPE["nx"])

    def run_lape():
        table = xt.cal_area_eqCoord_table_hist(
            lape_mask, lape_grid.ydef, lape_grid.dA, increase=False, lt=False)
        return timed_steps(
            lambda q: xt.lwa_pipeline(q, lape_grid, lape_mask, N=LAPE["N"],
                                      increase=False, lt=False, table=table),
            [lape_q] * S)
    # one K2, one K3 and one K5 launch a step, and K2 once for the table
    lape_outs, times = drive("lape", {"weighted_cdf": S, "lwa_lin": S,
                                      "lwa_lin2": S}, run_lape,
                             exact=dict(weighted_cdf=S + 1, lwa_lin=S,
                                        lwa_lin2=S, contour_levels=S))
    for out in lape_outs:
        check_lape(out, lshape, LAPE["N"], "lape")
    rates["lape"] = (LAPE["B"] / statistics.median(times), None, times)
    log(f"phase 4 lape: step s {[round(t, 5) for t in times]}: checks OK")

    pre_y = torch.linspace(-88.0, 88.0, 177, device=dev)

    def run_keff():
        table = era_table()
        return [xt.keff_pipeline(q, era_grid, pre_y=pre_y, N=ERA5["N"],
                                 table=t)
                for q, t in ((era_steps[0], table), (era_steps[1], None))]
    for i, out in enumerate(drive("keff era5 hist",
                                  {"squared_gradient": 2, "weighted_cdf": 2},
                                  run_keff, exact={"contour_levels": 2})):
        check_keff_pipeline(out, ERA5["B"], ERA5["N"], pre_y.shape[0],
                            f"keff era5 hist step {i}")
    out = drive("keff headline broadcast", {"squared_gradient": 1},
                lambda: xt.keff_pipeline(head_q, head_grid, N=HEADLINE["N"],
                                         hist=False),
                exact={"contour_levels": 1})
    check_keff_pipeline(out, HEADLINE["B"], HEADLINE["N"], None,
                        "keff headline broadcast")
    out = drive("keff_lwa era5 with_lwa2",
                {"squared_gradient": 1, "weighted_cdf": 1, "lwa_lin": 1,
                 "lwa_lin2": 1},
                lambda: xt.keff_lwa_pipeline(era_steps[0], era_grid,
                                             N=ERA5["N"], with_lwa2=True),
                exact={"contour_levels": 1})
    check_step(out, ERA5["B"], ERA5["nlat"], ERA5["N"],
               "keff_lwa era5 with_lwa2")
    out = drive("lwa tall dense", {"weighted_cdf": 1, "lwa_dense_tall": 2},
                lambda: xt.lwa_pipeline(tall_q, tall_grid, N=TALL["N"],
                                        lwa_method="dense"),
                exact={"contour_levels": 1})
    check_lwa_step(out, tuple(tall_q.shape), TALL["N"], -90.0, 90.0,
                   "lwa tall dense")
    log("phase 4 keff era5 hist, keff headline broadcast, keff_lwa with_lwa2, "
        "lwa tall dense: checks OK")

    # the geometry paths: clength_pipeline at ERA5 (K2 once for its five
    # integrals, K7), fractal_pipeline at the headline shape (K2, K7 once a
    # stride), local_contour_lengths on each ERA5 level (K8)
    for N in CLENGTH_N:
        def run(N=N):
            table = era_table()
            fn = lambda q, t: xt.clength_pipeline(q, era_grid, N=N, table=t)
            outs, times = timed_steps(lambda q: fn(q, table), era_steps[:S])
            own, own_t = timed_steps(lambda q: fn(q, None), era_steps[S:])
            return outs + own, times, own_t
        outs, times, own_t = drive(f"clength era5 N={N}",
                                   {"weighted_cdf": SE, "contour_lengths": SE},
                                   run, exact={"weighted_cdf": SE + 2,
                                               "clength_weights": SE,
                                               "contour_levels": SE})
        shares = [check_clength(out, era_steps[i], N,
                                f"clength era5 N={N} step {i}")
                  for i, out in enumerate(outs)]
        rates[f"clength_era5_n{N}"] = (ERA5["B"] / statistics.median(times),
                                       ERA5["B"] / own_t[0], times)
        log(f"phase 4 clength era5 N={N}: {S} steps with table reuse, step s "
            f"{[round(t, 5) for t in times]}, own-table step {own_t[0]:.5f} s: "
            f"checks OK; share of interior levels with Leq >= L >= Lmin "
            f"(1e-3) {[round(x, 4) for x in shares]}")
    nf = 3
    outs, times = drive(
        "fractal headline",
        {"weighted_cdf": nf, "contour_lengths": nf * len(FRACTAL_STRIDES),
         "box_counts": nf},
        lambda: timed_steps(
            lambda q: xt.fractal_pipeline(q, head_grid, N=HEADLINE["N"],
                                          strides=FRACTAL_STRIDES,
                                          table=head_table),
            [head_q] * nf), exact={"box_counts": nf, "contour_levels": nf})
    meds = [check_fractal(out, head_q, HEADLINE["N"], "fractal headline")
            for out in outs]
    rates["fractal_headline"] = (HEADLINE["B"] / statistics.median(times[1:]),
                                 None, times)
    log(f"phase 4 fractal headline: step s {[round(t, 5) for t in times]}: "
        f"checks OK; median D, D_bc {[round(x, 4) for x in meds[0]]}")

    def run_local():
        return timed_steps(
            lambda q: xt.local_length_pipeline(q, era_grid, **LOCAL),
            era_steps[:S])
    outs, times = drive("local era5", {"local_lengths": S, "window_means": S},
                        run_local,
                        exact={"local_lengths": S, "window_means": S,
                               "contour_levels": 0})
    for i, out in enumerate(outs):
        check_local([(out["llen"][k], out["y_window"], out["x_window"])
                     for k in range(ERA5["B"])], f"local era5 step {i}")
    rates["local_era5"] = (ERA5["B"] / statistics.median(times), None, times)
    log(f"phase 4 local era5: {S} steps of local_length_pipeline (one R and "
        f"one K8 launch a step), step s {[round(t, 5) for t in times]}: checks OK")
    # each step cell's entry at its shape, replayed as a CUDA graph
    era_shape = (LOCAL_B, ERA5["nlat"], ERA5["nlon"])
    graph_checks(dev, records, [
        ("era5.keff_lwa", xt.keff_lwa_pipeline, era_shape,
         dict(N=241, lwa_method="auto", table=True)),
        ("era5.clength", xt.clength_pipeline, era_shape,
         dict(N=401, table=True)),
        ("t170.fractal", xt.fractal_pipeline,
         (HEADLINE["B"], HEADLINE["nlat"], HEADLINE["nlon"]),
         dict(N=121, strides=FRACTAL_STRIDES, box_counting=True,
              table=True)),
        ("era5.local", xt.local_length_pipeline, era_shape, LOCAL),
        ("lape.lwa", xt.lwa_pipeline, (LAPE["B"], LAPE["nz"], LAPE["nx"]),
         dict(N=121, increase=False, lt=False, lwa_method="auto",
              table=True)),
        ("era5.lwa_split", xt.lwa_pipeline, era_shape,
         dict(N=241, part="split", lwa_method="auto", table=True))])
    timed = timed_graph_checks(dev, [
        ("era5.keff_lwa", xt.keff_lwa_pipeline, era_shape,
         dict(N=241, lwa_method="auto")),
        ("era5.clength", xt.clength_pipeline, era_shape, dict(N=401))])
    log("phase 4 timed graph json " + json.dumps(timed))
    log(f"phase 4 launches over all paths: {totals}")
    # the decode runs through the runner alone: phase 10
    missing = [n for n, c in totals.items()
               if c == 0 and n != decode.KERNEL.name]
    _expect(not missing, f"kernels never launched by the paths: {missing}")

    # 5. card against CPU on one small step each
    slat, slon, spv = make_pv(2, 256, 512, 7)
    cgrid = xt.from_latlon(slat, slon, device="cpu")
    ggrid = xt.from_latlon(slat, slon, device=dev)
    sq_cpu, sq_gpu = torch.as_tensor(spv), torch.as_tensor(spv).to(dev)
    for method in ("auto", "dense"):
        kw = dict(N=121, lwa_method=method)
        card_vs_cpu(f"keff_lwa 2x256x512 {method}",
                    xt.keff_lwa_pipeline(sq_cpu, cgrid, **kw),
                    xt.keff_lwa_pipeline(sq_gpu, ggrid, **kw))
        card_vs_cpu(f"lwa 2x256x512 {method}",
                    xt.lwa_pipeline(sq_cpu, cgrid, metric="dy", **kw),
                    xt.lwa_pipeline(sq_gpu, ggrid, metric="dy", **kw))
    sv, sb = lape_data(4, seed=3)
    lkw = dict(N=LAPE["N"], increase=False, lt=False)
    lmask = torch.as_tensor(sv["maskC"])
    card_vs_cpu(
        f"lape 4x{LAPE['nz']}x{LAPE['nx']}",
        xt.lwa_pipeline(torch.as_tensor(sb),
                        xt.from_xz(sv["Z"], sv["XC"], sv["hFacC"],
                                   mask=sv["maskC"], device="cpu"),
                        lmask, **lkw),
        xt.lwa_pipeline(torch.as_tensor(sb).to(dev),
                        xt.from_xz(sv["Z"], sv["XC"], sv["hFacC"],
                                   mask=sv["maskC"], device=dev),
                        lmask.to(dev), **lkw))
    spre = torch.linspace(-80.0, 80.0, 33)
    for hist_path in (True, False):
        kw = dict(N=121, hist=hist_path)
        card_vs_cpu(f"keff 2x256x512 hist={hist_path}",
                    flat_keff(xt.keff_pipeline(sq_cpu, cgrid, pre_y=spre, **kw)),
                    flat_keff(xt.keff_pipeline(sq_gpu, ggrid,
                                               pre_y=spre.to(dev), **kw)))
    card_vs_cpu("clength 2x256x512", xt.clength_pipeline(sq_cpu, cgrid, N=121),
                xt.clength_pipeline(sq_gpu, ggrid, N=121), nkeff_mask=1e5)
    fkw = dict(N=121, strides=(1, 2, 4))
    card_vs_cpu("fractal 2x256x512", xt.fractal_pipeline(sq_cpu, cgrid, **fkw),
                xt.fractal_pipeline(sq_gpu, ggrid, **fkw))

    means = xt.rolling_mean(sq_cpu[0], 33, 8)[0]

    def local(q, grid):
        lengths, cy, cx = xt.local_contour_lengths(
            q[0], grid.ydef, grid.xdef, window=33, stride=8,
            levels=means.to(q.device))
        return dict(local_lengths=lengths, cy=cy, cx=cx,
                    means=xt.rolling_mean(q[0], 33, 8)[0])
    card_vs_cpu("local 256x512 window 33", local(sq_cpu, cgrid),
                local(sq_gpu, ggrid))

    # 6. timing with CUDA events
    timing, work = {}, {}
    for label in ("era5", "headline", "tall", "lape"):
        for name, (kern, plain, w) in cases[label].items():
            key = name if label == "tall" else (label, name)
            timing[key], work[key] = (cuda_ms(kern, 20), cuda_ms(plain, 3)), w
            log(f"phase 6 time {name} {label}: kernel {timing[key][0]:.4f} "
                f"ms, plain {timing[key][1]:.4f} ms")
    for name, (kern, plain, w) in k2_cases(era_steps[0], era_grid,
                                           ERA5["N"]).items():
        key = ("era5", name)
        timing[key], work[key] = (cuda_ms(kern, 20), cuda_ms(plain, 3)), w
        log(f"phase 6 time {name} era5: kernel {timing[key][0]:.4f} ms, "
            f"plain {timing[key][1]:.4f} ms")
    # one timed call of each float32 plain version (N = 401 takes seconds)
    for name, (_, kern, plain, _, w, pairs) in cases["length"].items():
        timing[name], work[name] = (cuda_ms(kern, 20), cuda_ms(plain, 1)), w
        log(f"phase 6 time {name}: kernel {timing[name][0]:.4f} ms, plain "
            f"{timing[name][1]:.4f} ms")
        log(f"phase 6 crossed {name}: {pairs} crossed pairs; bound counts "
            f"{w[1]} FP32 instructions, {w[0]} bytes")
    # where K3's and K5's time goes (prep against surface kernel), and
    # whether the FP32-bound kernels run at the SM clock they are bound at
    for name in ("lwa_lin", "lwa_lin2"):
        for kname, ms in device_split(cases["era5"][name][0]).items():
            log(f"phase 6 split {name} era5 {kname}: {ms:.4f} ms device "
                f"time a call")
    for name in ("lwa_lin", "lwa_dense"):
        mhz, watts, n, ms = clock_under_load(cases["era5"][name][0])
        log(f"phase 6 load {name} era5: {ms:.4f} ms a call back to back; "
            f"SM clock median {mhz:.0f} MHz, power median {watts:.1f} W "
            f"({n} nvidia-smi samples)")
    for key, (reuse, own, times) in rates.items():
        extra = "" if own is None else f", own-table step {own:.1f}"
        log(f"phase 6 rate {key}: {reuse:.1f} snapshots/s (median step, "
            f"table reused){extra}")
    for label, peak in peaks.items():
        log(f"phase 6 peak device memory {label}: {peak:.3f} GiB")
    # D in turns with its plain version and Tensor.copy_ of its output (the
    # device's times, utils.roofline.time_alternating)
    decode_copy = {}
    for name, (kern, plain, _, w) in decode_cases(dev).items():
        key, out = f"decode_{name}", kern()
        dst = torch.empty_like(out)
        k_ms, p_ms, c_ms = time_alternating(
            [kern, plain, lambda: dst.copy_(out)], dev, reps=20)
        timing[key], work[key] = (k_ms, p_ms), w
        decode_copy[key] = (c_ms, bound_ms((2 * out.numel()
                                            * out.element_size(), 0))[0])
        del out, dst
    # B in turns with its plain version at the t170.fractal step
    kern, plain, _, w = boxcount_case(head_q, head_grid, HEADLINE["N"])
    timing["box_counts"] = tuple(time_alternating([kern, plain], dev,
                                                  reps=20))
    work["box_counts"] = w
    # R in turns with its plain version (the integral images) at the
    # era5.local step
    from xcontour_tpu_torch.kernels import rolling
    timing["window_means"] = tuple(time_alternating(
        [lambda: rolling.window_means(local_q, **LOCAL),
         lambda: rolling.window_means_plain(local_q, **LOCAL)], dev,
        reps=20))
    work["window_means"] = window_means_work(
        *local_q.shape, LOCAL["window"], LOCAL["stride"],
        local_q.element_size())
    # G in turns with its plain version at the ERA5 step and at the
    # era5.clength step (16 snapshots)
    g_steps = (("era5", era_steps[0]), ("era5.clength", local_q))
    for label, gq in g_steps:
        kern, plain, w = clength_weights_case(gq, era_grid)
        key = f"clength_weights_{label}"
        timing[key] = tuple(time_alternating([kern, plain], dev, reps=20))
        work[key] = w
    # E in turns with the plain chain at the three cells' steps; bytes: the
    # tracer read once and the levels written
    from xcontour_tpu_torch.kernels import extrema
    e_cases = contour_levels_cases(local_q, head_q, lape_q)
    for label, q, N, inc in e_cases:
        key = f"contour_levels_{label}"
        timing[key] = tuple(time_alternating(
            [lambda q=q, N=N, inc=inc: extrema.contour_levels(
                q, N, increase=inc),
             lambda q=q, N=N, inc=inc: extrema.contour_levels_plain(
                 q, N, increase=inc)], dev, reps=20))
        work[key] = (q.element_size() * (q.numel() + q.shape[0] * N), 0)

    # K1-K8 against their bounds, with launches per step of their paths
    # (the table builds of the streamed runs included)
    k7_main = f"contour_lengths_n{CLENGTH_N[0]}"
    era_auto = "keff_lwa era5 auto"
    table = [(stencil.KERNEL, ("era5", "squared_gradient"), era_auto, SE),
             (hist.KERNEL, ("era5", "weighted_cdf"), era_auto, SE),
             (lwa.KERNEL_LIN, ("era5", "lwa_lin"), era_auto, SE),
             (lwa.KERNEL_DENSE, ("era5", "lwa_dense"), "keff_lwa era5 dense",
              SE),
             (lwa.KERNEL_LIN2, ("era5", "lwa_lin2"), "lwa era5 auto", SE),
             (lwa.KERNEL_DENSE_TALL, "lwa_dense_tall", "lwa tall dense", 1),
             (length.KERNEL_LENGTHS, k7_main, f"clength era5 N={CLENGTH_N[0]}",
              SE),
             (length.KERNEL_LOCAL_LENGTHS, "local_lengths", "local era5", S)]
    bounds = {}
    for i, (r, key, path, steps) in enumerate(table):
        bounds[key] = bound_ms(work[key])
        k_ms, p_ms = timing[key]
        b_ms, b_by = bounds[key]
        log(f"phase 6 kernel K{i + 1} {r.name}: {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / k_ms:.2f}% of bound, "
            f"{path_counts[path][r.name] / steps:g} launches per step of "
            f"'{path}', library call none")
    lape_shape = "x".join(map(str, lape_q.shape))
    for i, name in ((3, "lwa_lin"), (5, "lwa_lin2")):
        key = ("lape", name)
        bounds[key] = bound_ms(work[key])
        (k_ms, p_ms), (b_ms, b_by) = timing[key], bounds[key]
        log(f"phase 6 kernel K{i} {name} lape {lape_shape} increase=False: "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {100 * b_ms / k_ms:.2f}% of bound, "
            f"{path_counts['lape'][name] / S:g} launches per step of 'lape'")
    for key in (*(("era5", f"weighted_cdf_{t}") for t in K2_SHAPES),
                ("era5", "lwa_dense_v2"), ("era5", "lwa_dense_upper"),
                ("era5", "lwa_dense_split"),
                "lwa_dense_tall_v2", f"contour_lengths_n{CLENGTH_N[1]}",
                "contour_lengths_cartesian",
                *(f"local_lengths_w{w}s{s}" for w, s in K8_WINDOWS)):
        bounds[key] = bound_ms(work[key])
        k_ms, b_ms = timing[key][0], bounds[key][0]
        log(f"phase 6 kernel {key}: {k_ms:.4f} ms, plain "
            f"{timing[key][1]:.4f} ms, bound {b_ms:.4f} ms "
            f"({bounds[key][1]}), {100 * b_ms / k_ms:.2f}% of bound")
    for name, *_ in DECODE_CASES:
        key = f"decode_{name}"
        bounds[key] = bound_ms(work[key])
        (k_ms, p_ms), (b_ms, b_by) = timing[key], bounds[key]
        c_ms, cb_ms = decode_copy[key]
        log(f"phase 6 kernel D {decode.KERNEL.name} {name}: {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / k_ms:.2f}% of bound; Tensor.copy_ of the output "
            f"{c_ms:.4f} ms ({100 * cb_ms / c_ms:.2f}% of its bound); "
            "launches: phase 10")
    bounds["box_counts"] = bound_ms(work["box_counts"])
    (k_ms, p_ms), (b_ms, b_by) = timing["box_counts"], bounds["box_counts"]
    log(f"phase 6 kernel B {boxcount.KERNEL.name} t170.fractal step "
        f"{HEADLINE['B']}x{HEADLINE['nlat']}x{HEADLINE['nlon']} N="
        f"{HEADLINE['N']} strides {list(FRACTAL_STRIDES)}: {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{100 * b_ms / k_ms:.2f}% of bound, "
        f"{path_counts['fractal headline'][boxcount.KERNEL.name] / nf:g} "
        "launches per step of 'fractal headline', library call none")
    bounds["window_means"] = bound_ms(work["window_means"])
    (k_ms, p_ms), (b_ms, b_by) = timing["window_means"], bounds["window_means"]
    log(f"phase 6 kernel R {rolling.KERNEL.name} era5.local step "
        f"{'x'.join(map(str, local_q.shape))} window {LOCAL['window']} / "
        f"stride {LOCAL['stride']}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / k_ms:.2f}% of bound, "
        f"{path_counts['local era5'][rolling.KERNEL.name] / S:g} launches "
        "per step of 'local era5', library call none")
    g_path = f"clength era5 N={CLENGTH_N[0]}"
    for label, gq in g_steps:
        key = f"clength_weights_{label}"
        bounds[key] = bound_ms(work[key])
        (k_ms, p_ms), (b_ms, b_by) = timing[key], bounds[key]
        log(f"phase 6 kernel G {gradw.KERNEL.name} {label} step "
            f"{'x'.join(map(str, gq.shape))}: {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: 24 a cell, the "
            f"grid's dx, dy, dA once), {100 * b_ms / k_ms:.2f}% of bound, "
            f"{path_counts[g_path][gradw.KERNEL.name] / SE:g} launches per "
            f"step of '{g_path}', library call none")
    # each shape's phase-4 path and its steps
    e_paths = {"era5": (era_auto, SE), "t170.fractal": ("fractal headline",
                                                        nf),
               "lape.lwa": ("lape", S)}
    for label, q, N, inc in e_cases:
        key = f"contour_levels_{label}"
        bounds[key] = bound_ms(work[key])
        (k_ms, p_ms), (b_ms, b_by) = timing[key], bounds[key]
        path, steps = e_paths[label]
        log(f"phase 6 kernel E {extrema.KERNEL.name} {label} step "
            f"{'x'.join(map(str, q.shape))} N={N} increase={inc}: "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: the tracer once, the levels out), "
            f"{100 * b_ms / k_ms:.2f}% of bound, "
            f"{path_counts[path][extrema.KERNEL.name] / steps:g} calls (two "
            f"launches each) per step of '{path}', library call none")

    split_turns(era_steps[0], era_grid, ERA5["N"], dev)

    # 7. gradients: the autograd Functions on the card
    t0 = time.perf_counter()
    grad_times, grad_steps = grad_phase(dev, records, era_steps[0], era_grid,
                                        era_table(), head_q, head_grid,
                                        head_table)
    log(f"phase 7 gradients: OK in {time.perf_counter() - t0:.1f} s")

    # 8. the sort engines: exact integrals, cal_contours_at, 'fast' LWA,
    # the lin/fast ladder and 'auto' on either side of the crossover
    from xcontour_tpu_torch.diagnostics.lwa import _FAST_NY_CROSSOVER
    t0 = time.perf_counter()
    sort_table = era_table()
    sort_timing, sort_levels = exact_checks(dev, drive, era_steps[0],
                                            era_grid, sort_table)
    fast_checks(dev, drive, era_steps[0], era_grid, sort_table, tall_q,
                tall_grid)
    era_Q = xt.keff_lwa_pipeline(era_steps[0], era_grid, N=ERA5["N"],
                                 table=sort_table)["Q"].contiguous()
    rows, cross = ladder(dev, era_steps[0], era_Q, era_grid)
    log(f"phase 8 crossover: 'fast' faster from Ny = {cross['lwa']} (LWA), "
        f"{cross['lwa2']} (LWA2) and {cross['both']} (both) of the ladder "
        f"on; the port's _FAST_NY_CROSSOVER = {_FAST_NY_CROSSOVER}")
    log(f"phase 8 ladder json {json.dumps(dict(rows=rows, crossover=cross))}")
    auto_checks(dev, drive)
    log(f"phase 8 sort engines: OK in {time.perf_counter() - t0:.1f} s")

    # 9. the facade: Contour2D, the reference namespace, labelled datasets
    t0 = time.perf_counter()
    chains, facade_labels, _ = facade_phase(
        dev, drive, path_counts, era_steps, era_grid, sort_table, sort_timing,
        sort_levels, lape_q, lape_outs[0], lv)
    facade_counts = {r.name: sum(path_counts[label][r.name]
                                 for label in facade_labels)
                     for r in records}
    log(f"phase 9 launches over the facade's paths: {facade_counts}")
    log(f"phase 9 json {json.dumps(chains)}")
    log(f"phase 9 facade: OK in {time.perf_counter() - t0:.1f} s")

    # 10. an ERA5-width archive through the runner and the CLI
    t0 = time.perf_counter()
    par_cli_labels = []

    def mesh_cli(path, base, got, T, tmp):
        # phase 11's CLI checks, on phase 10's archive
        par_cli_labels.extend(parallel_cli(
            drive, {r.name: 0 for r in records}, path, base, got, T, tmp))
    cli_res, cli_labels = cli_phase(dev, drive, path_counts, peaks, card,
                                    then=mesh_cli)
    clength_launch_checks(era_steps, era_grid)
    cli_counts = {r.name: sum(path_counts[label][r.name]
                              for label in cli_labels) for r in records}
    log(f"phase 10 launches over the CLI's paths: {cli_counts}")
    missing = [n for n, c in cli_counts.items() if c == 0]
    _expect(not missing, f"kernels never launched through the CLI: {missing}")
    log(f"phase 10 json {json.dumps(cli_res)}")
    log(f"phase 10 runner and CLI: OK in {time.perf_counter() - t0:.1f} s")

    # 11. the sharded path: in process on a mesh of one, then gloo ranks
    t0 = time.perf_counter()
    par_res, par_labels, par_grad_labels = parallel_phase(
        dev, drive, era_steps, era_grid)
    par_counts = {r.name: sum(path_counts[label][r.name]
                              for label in par_labels + par_cli_labels)
                  for r in records}
    par_grad_counts = {r.name: sum(path_counts[label][r.name]
                                   for label in par_grad_labels)
                       for r in records}
    log(f"phase 11 launches over the sharded paths: {par_counts}; over the "
        f"sharded adjoints: {par_grad_counts}")
    missing = [n for n in ("squared_gradient", "weighted_cdf", "lwa_lin",
                           "lwa_dense", "lwa_lin2", "contour_lengths",
                           "local_lengths", "contour_levels")
               if par_counts[n] == 0]
    _expect(not missing, f"kernels never launched by the sharded paths: "
                         f"{missing}")
    log(f"phase 11 json {json.dumps(par_res)}")
    log(f"phase 11 sharded path: OK in {time.perf_counter() - t0:.1f} s")

    # 12. the structure probes P1-P4 against their plain versions, then
    # kernel_rooflines (K1, K2, K3, K7 beside them) at ERA5 and headline
    from xcontour_tpu_torch.kernels import probes
    t0 = time.perf_counter()
    records.extend(probes.PROBES)
    totals.update({r.name: 0 for r in probes.PROBES})
    probe_errs = probe_checks("era5", era_steps[0], era_grid, ERA5["N"],
                              CLENGTH_N)
    probe_checks("headline", head_q, head_grid, HEADLINE["N"],
                 (HEADLINE["N"],))
    roof = roofline_phase(dev, drive, card, (
        ("era5", ERA5, era_steps[0], era_grid),
        ("headline", HEADLINE, head_q, head_grid)))
    log(f"phase 12 probes: OK in {time.perf_counter() - t0:.1f} s")

    def entry(r, key, err_key, extra=()):
        e = dict(name=r.name, route="cuda", source=r.source,
                 replaces=r.replaces, launches=totals[r.name],
                 max_abs_err=errs[err_key], ms=timing[key][0],
                 plain_ms=timing[key][1], bound_ms=bounds[key][0],
                 bound_by=bounds[key][1], library_ms=LIBRARY_MS,
                 backward_ms=grad_times[r.name][1],
                 backward_peak_gib=grad_times[r.name][2],
                 launches_facade=facade_counts[r.name],
                 launches_cli=cli_counts[r.name],
                 launches_parallel=par_counts[r.name],
                 launches_parallel_grad=par_grad_counts[r.name])
        if r.name in structure:
            key12 = structure[r.name]
            e.update(pct_of_structure_ceiling=roof["era5"][key12][
                "pct_of_structure_ceiling"],
                pct_of_structure_ceiling_headline=roof["headline"][key12][
                    "pct_of_structure_ceiling"],
                roofline_ms=roof["era5"][key12]["ms"])
        for tag, k in extra:
            if k in errs:
                e[f"max_abs_err_{tag}"] = errs[k]
            tk = ("era5", k) if isinstance(key, tuple) else k
            e.update({f"ms_{tag}": timing[tk][0],
                      f"plain_ms_{tag}": timing[tk][1]})
            if tk in bounds:
                e[f"bound_ms_{tag}"] = bounds[tk][0]
        return e
    structure = {roof["era5"][key]["kernel"]: key for key in ROOFLINE_KEYS}

    def probe_entry(key):
        r, head = roof["era5"][key], roof["headline"][key]
        p = next(p for p in probes.PROBES if p.name == r["probe"])
        return dict(name=p.name, route="cuda", source=p.source,
                    replaces=p.replaces, launches=totals[p.name],
                    max_abs_err=probe_errs[p.name], ms=r["probe_ms"],
                    plain_ms=r["probe_plain_ms"], bound_ms=r["probe_bound_ms"],
                    bound_by=r["probe_bound_by"],
                    library_ms=r.get("library_ms"),
                    pct_of_bound=r["probe_pct_of_bound"],
                    ms_headline=head["probe_ms"],
                    bound_ms_headline=head["probe_bound_ms"])
    def decode_entry():
        # D at the archive's layout, the other layouts under their names;
        # no library call decodes
        r, (main, *rest) = decode.KERNEL, [c[0] for c in DECODE_CASES]
        key = f"decode_{main}"
        e = dict(name=r.name, route="cuda", source=r.source,
                 replaces=r.replaces, launches=totals[r.name],
                 max_abs_err=errs[key], ms=timing[key][0],
                 plain_ms=timing[key][1], bound_ms=bounds[key][0],
                 bound_by=bounds[key][1], library_ms=None,
                 copy_ms=decode_copy[key][0],
                 launches_facade=facade_counts[r.name],
                 launches_cli=cli_counts[r.name],
                 launches_parallel=par_counts[r.name])
        for tag in rest:
            k = f"decode_{tag}"
            e.update({f"max_abs_err_{tag}": errs[k], f"ms_{tag}": timing[k][0],
                      f"plain_ms_{tag}": timing[k][1],
                      f"bound_ms_{tag}": bounds[k][0]})
        return e
    def window_entry(r, key):
        return dict(name=r.name, route="cuda", source=r.source,
                    replaces=r.replaces, launches=totals[r.name],
                    max_abs_err=errs[key], ms=timing[key][0],
                    plain_ms=timing[key][1], bound_ms=bounds[key][0],
                    bound_by=bounds[key][1], library_ms=None,
                    launches_facade=facade_counts[r.name],
                    launches_cli=cli_counts[r.name],
                    launches_parallel=par_counts[r.name])

    def boxcount_entry():
        r, key = boxcount.KERNEL, "box_counts"
        return dict(name=r.name, route="cuda", source=r.source,
                    replaces=r.replaces, launches=totals[r.name],
                    max_abs_err=errs[key], ms=timing[key][0],
                    plain_ms=timing[key][1], bound_ms=bounds[key][0],
                    bound_by=bounds[key][1], library_ms=None,
                    launches_facade=facade_counts[r.name],
                    launches_cli=cli_counts[r.name],
                    launches_parallel=par_counts[r.name])
    k2_extra = tuple((tag, f"weighted_cdf_{tag}") for tag in K2_SHAPES)
    kernels_line = {"kernels": [
        entry(r, key, key[1] if isinstance(key, tuple) else key,
              k2_extra if r is hist.KERNEL else ())
        for r, key, _, _ in table[:3]] + [
        entry(lwa.KERNEL_DENSE, ("era5", "lwa_dense"), "lwa_dense",
              (("v2", "lwa_dense_v2"), ("upper", "lwa_dense_upper"))),
        entry(lwa.KERNEL_LIN2, ("era5", "lwa_lin2"), "lwa_lin2"),
        entry(lwa.KERNEL_DENSE_TALL, "lwa_dense_tall", "lwa_dense_tall",
              (("v2", "lwa_dense_tall_v2"),)),
        entry(length.KERNEL_LENGTHS, k7_main, k7_main,
              tuple((tag, f"contour_lengths_{tag}")
                    for tag in (f"n{CLENGTH_N[1]}", "cartesian"))),
        entry(length.KERNEL_LOCAL_LENGTHS, "local_lengths", "local_lengths")]
        + [probe_entry(key) for key in ("lwa", "hist_cdf2", "length",
                                        "stencil")]
        + [decode_entry(), boxcount_entry(),
           window_entry(rolling.KERNEL, "window_means"),
           window_entry(gradw.KERNEL, "clength_weights_era5"),
           window_entry(extrema.KERNEL, "contour_levels_era5")]}
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
