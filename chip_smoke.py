#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``xcontour_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``xcontour_tpu_torch/csrc`` and drives the
port's main path, ``keff_lwa_pipeline``, at ERA5 scale: 721x1440 global
isentropic PV, 15 levels per step, N=241 contours, lmin='analytic',
metric='dA', with a seeded below-ground NaN patch on the lowest levels.

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the kernels with nvcc;
  3. kernel checks: K1-K4 against their plain PyTorch versions on the same
     CUDA tensors, at the slice's shapes, each within its stated bound;
  4. the slice: launch counts reset, then for lwa_method 'auto' and
     'dense' an A(Y_eq) table built once and 4 ERA5 steps that reuse it,
     plus one step that builds its own table; every kernel must have been
     launched, and the outputs are checked (intArea monotone, Yeq in
     [-90, 90], finite where the JAX semantics say so); then the JAX
     bench's headline shape, 32x256x512 with N=121;
  5. card against CPU: one 2x256x512 step on the card against the same
     step on the CPU (plain versions), float32, stated tolerances;
  6. timing with CUDA events: per-kernel and plain-version ms, snapshots/s
     of each step, peak device memory.

The last three lines are the kernels JSON, the card line from nvidia-smi,
and {"ok": true, "device": {...}}.  Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ERA5 = dict(B=15, nlat=721, nlon=1440, N=241)
HEADLINE = dict(B=32, nlat=256, nlon=512, N=121)
STREAM_STEPS = 4

# kernel vs plain version on the same CUDA tensors, relative to the plain
# output's largest magnitude
#   K1: the same float32 operations in the same order (no FMA): exact
#   K2: float32 sums in another order (shared-memory atomics, partials)
#   K3: the 'lin' float32 floor (R and E cancel), the JAX suite's bound
#   K4: the reference-order float32 bound of the JAX suite
KERNEL_BOUNDS = dict(squared_gradient=1e-6, weighted_cdf=1e-5,
                     lwa_lin=1.5e-4, lwa_dense=5e-6)
# card (kernels) against CPU (plain versions), float32, relative to each
# output's largest magnitude: summation order for the sorted state (2e-5);
# Yeq and Lmin come from a table lookup of float32 areas, where near the
# poles dYeq/dA is steep (1e-4); Leq2 differences CDFs along the contour
# index (1e-4); lwa at the 'lin' floor; nkeff = Leq2 / Lmin^2 with
# Lmin ~ cos(Yeq): near the poles a Yeq difference of d radians moves it by
# 2 tan(Yeq) d, ~1e3 times the area noise, and a value at its 2e7
# threshold may be NaN on one side only
CARD_CPU_TOL = dict(Yeq=1e-4, Lmin=1e-4, Leq2=1e-4, nkeff=2e-3, lwa=1.5e-4)
CARD_CPU_TOL_DEFAULT = 2e-5
NKEFF_MASK = 2e7


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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


def threshold_agree(got, want, tol):
    """nkeff is NaN at and above its threshold: a cell NaN on one side only
    is accepted when the other side lies within ``tol`` of the threshold,
    and then set NaN on both sides."""
    one = torch.isnan(got) ^ torch.isnan(want)
    other = torch.where(torch.isnan(got), want, got)[one]
    if bool((other < NKEFF_MASK * (1 - tol)).any()):
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


def kernel_cases(q, grid, N):
    """name -> (kernel call, plain call) for the four kernels, at the shapes
    the main path gives them: the inputs are what keff_lwa_pipeline
    computes on the way."""
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
    return {
        "squared_gradient": (
            lambda: stencil.squared_gradient(q, rdx, rdy,
                                             periodic_x=grid.periodic_x),
            lambda: stencil.squared_gradient_plain(
                q, rdx, rdy, periodic_x=grid.periodic_x)),
        "weighted_cdf": (
            lambda: hist.weighted_cdf(vf, edges.contiguous(), wf),
            lambda: hist.weighted_cdf_plain(vf, edges, wf)),
        "lwa_lin": (
            lambda: lwa.lwa_lin(q, Q, W, increase=True),
            lambda: lwa.lwa_lin_plain(q, Q, W, increase=True)),
        "lwa_dense": (
            lambda: lwa.lwa_dense(q, Q, W, increase=True),
            lambda: lwa.lwa_dense_plain(q, Q, W, increase=True)),
    }


def variant_cases(q, grid):
    """(name, kernel call, plain call, bound) for the modes the slice does
    not run: non-periodic x, 'fill' and 'reflect' walls, a decreasing
    tracer, and the upper/lower part selections."""
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
    cases.append(("lwa_lin increase=False",
                  lambda: lwa.lwa_lin(qd, Qd, W, increase=False),
                  lambda: lwa.lwa_lin_plain(qd, Qd, W, increase=False),
                  KERNEL_BOUNDS["lwa_lin"]))
    for inc, qq, QQ in ((True, q, Q), (False, qd, Qd)):
        for part in ("all", "upper", "lower"):
            kw = dict(increase=inc, part=part)
            cases.append((f"lwa_dense increase={inc} {part}",
                          lambda kw=kw, qq=qq, QQ=QQ: lwa.lwa_dense(qq, QQ, W, **kw),
                          lambda kw=kw, qq=qq, QQ=QQ: lwa.lwa_dense_plain(qq, QQ, W, **kw),
                          KERNEL_BOUNDS["lwa_dense"]))
    return cases


def check_step(out, B, Ny, N, where):
    """What the JAX semantics guarantee for a step's outputs."""
    from xcontour_tpu_torch.ops.gradient import gradient_index
    shapes = dict(contour=(B, N), intArea=(B, N), intgrdS=(B, N), Yeq=(B, N),
                  Lmin=(B, N), Leq2=(B, N), nkeff=(B, N), Q=(B, Ny))
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(f"{where}: {k} has shape {tuple(out[k].shape)}")
    for k in ("contour", "intArea", "intgrdS", "Yeq", "Lmin", "Q", "lwa"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{where}: {k} has non-finite values")
    # Leq2 = (dS/dA) / (dq/dA)^2 is 0/0 = NaN only where the enclosed area
    # does not change between neighbouring contours; nkeff is NaN there and
    # at or above its 2e7 threshold
    flat = gradient_index(out["intArea"]) == 0
    leq2, nkeff = out["Leq2"], out["nkeff"]
    if bool((torch.isnan(leq2) & ~flat).any()) or bool(torch.isinf(leq2).any()) \
            or bool((leq2[~torch.isnan(leq2)] < 0).any()):
        raise AssertionError(f"{where}: Leq2 negative, infinite or NaN "
                             "where the area changes")
    if bool(torch.isinf(nkeff).any()) or \
            bool((nkeff[~torch.isnan(nkeff)] < 0).any()):
        raise AssertionError(f"{where}: nkeff outside [0, 2e7) or NaN")
    if not bool((torch.diff(out["intArea"], dim=-1) >= 0).all()):
        raise AssertionError(f"{where}: intArea is not monotone")
    if not bool((torch.diff(out["intgrdS"], dim=-1) >= 0).all()):
        raise AssertionError(f"{where}: intgrdS is not monotone")
    yeq = out["Yeq"]
    if not bool(((yeq >= -90.0) & (yeq <= 90.0)).all()):
        raise AssertionError(f"{where}: Yeq outside [-90, 90]")


def run_steps(grid, steps, N, method, table):
    """Run keff_lwa_pipeline over pre-staged device batches; returns the
    outputs and the per-step wall times (each ends in a synchronize)."""
    import xcontour_tpu_torch as xt
    outs, times = [], []
    for q in steps:
        t0 = time.perf_counter()
        out = xt.keff_lwa_pipeline(q, grid, N=N, lwa_method=method,
                                   table=table)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    return outs, times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run", file=sys.stderr)
        return 1
    import xcontour_tpu_torch as xt
    from xcontour_tpu_torch.kernels import _build, hist, lwa, stencil

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = [stencil.KERNEL, hist.KERNEL, lwa.KERNEL_LIN, lwa.KERNEL_DENSE]

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
    hlat, hlon, hpv = make_pv(HEADLINE["B"], HEADLINE["nlat"],
                              HEADLINE["nlon"], 100)
    head_grid = xt.from_latlon(hlat, hlon, device=dev)
    head_q = torch.as_tensor(hpv).to(dev)
    torch.cuda.synchronize()
    log(f"set-up: data made and staged in {time.perf_counter() - t0:.2f} s")

    # 3. kernel checks at the slice's shapes
    cases, errs = {}, {}
    for label, grid, q, N in (("era5", era_grid, era_steps[0], ERA5["N"]),
                              ("headline", head_grid, head_q, HEADLINE["N"])):
        cases[label] = kernel_cases(q, grid, N)
        for name, (kern, plain) in cases[label].items():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            bound = KERNEL_BOUNDS[name]
            ok = rel <= bound
            log(f"phase 3 kernel {name} {label} {tuple(q.shape)}: max_abs_err "
                f"{err:.6g} rel {rel:.3e} bound {bound:g} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version")
            if label == "era5":
                errs[name] = err

    # the kernels' other modes, at the headline shape (the slice runs
    # periodic x, 'extend' walls, increase=True, part='all')
    q = head_q[:4].clone()
    q[0, 1, 5] = float("nan")          # the 'reflect' walls read row 1
    for name, kern, plain, bound in variant_cases(q, head_grid):
        _, rel = rel_err(kern(), plain())
        ok = rel <= bound
        log(f"phase 3 variant {name}: rel {rel:.3e} bound {bound:g} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")

    # 4. the slice, through the entry points a user calls
    for r in records:
        r.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rates = {}
    for method in ("auto", "dense"):
        table = xt.cal_area_eqCoord_table_hist(
            era_grid.fluid_mask(), era_grid.ydef, era_grid.dA,
            increase=True, lt=True)
        outs, times = run_steps(era_grid, era_steps[:STREAM_STEPS],
                                ERA5["N"], method, table)
        for i, out in enumerate(outs):
            check_step(out, ERA5["B"], ERA5["nlat"], ERA5["N"],
                       f"era5 {method} step {i}")
        own, own_t = run_steps(era_grid, era_steps[STREAM_STEPS:],
                               ERA5["N"], method, None)
        check_step(own[0], ERA5["B"], ERA5["nlat"], ERA5["N"],
                   f"era5 {method} own-table step")
        rates[f"era5_{method}"] = (ERA5["B"] / statistics.median(times),
                                   ERA5["B"] / own_t[0], times)
        log(f"phase 4 slice era5 {method}: {STREAM_STEPS} steps with table "
            f"reuse, step s {[round(t, 5) for t in times]}, own-table step "
            f"{own_t[0]:.5f} s: checks OK")
    head_table = xt.cal_area_eqCoord_table_hist(
        head_grid.fluid_mask(), head_grid.ydef, head_grid.dA,
        increase=True, lt=True)
    for method in ("auto", "dense"):
        outs, times = run_steps(head_grid, [head_q] * 5, HEADLINE["N"],
                                method, head_table)
        for out in outs:
            check_step(out, HEADLINE["B"], HEADLINE["nlat"], HEADLINE["N"],
                       f"headline {method}")
        rates[f"headline_{method}"] = (
            HEADLINE["B"] / statistics.median(times[1:]), None, times)
        log(f"phase 4 slice headline {method}: step s "
            f"{[round(t, 5) for t in times]}: checks OK")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {r.name: r.launches for r in records}
    log(f"phase 4 launches during the slice: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the slice: {missing}")

    # 5. card against CPU on one small step
    slat, slon, spv = make_pv(2, 256, 512, 7)
    for method in ("auto", "dense"):
        cpu = xt.keff_lwa_pipeline(torch.as_tensor(spv),
                                   xt.from_latlon(slat, slon), N=121,
                                   lwa_method=method)
        gpu = xt.keff_lwa_pipeline(torch.as_tensor(spv).to(dev),
                                   xt.from_latlon(slat, slon, device=dev),
                                   N=121, lwa_method=method)
        worst = []
        for k, want in cpu.items():
            got = gpu[k].cpu()
            if k == "nkeff":
                got, want = threshold_agree(got, want,
                                            CARD_CPU_TOL["nkeff"])
            _, rel = rel_err(got, want)
            tol = CARD_CPU_TOL.get(k, CARD_CPU_TOL_DEFAULT)
            worst.append(f"{k} {rel:.2e}/{tol:g}")
            if rel > tol:
                raise AssertionError(f"card vs CPU {method}: {k} rel {rel:.3e} "
                                     f"> {tol:g}")
        log(f"phase 5 card vs CPU 2x256x512 {method}: OK ({', '.join(worst)})")

    # 6. timing with CUDA events
    timing = {}
    for label in ("era5", "headline"):
        for name, (kern, plain) in cases[label].items():
            k_ms = cuda_ms(kern, 20)
            p_ms = cuda_ms(plain, 3)
            timing[(label, name)] = (k_ms, p_ms)
            log(f"phase 6 time {name} {label}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms")
    for key, (reuse, own, times) in rates.items():
        extra = "" if own is None else f", own-table step {own:.1f}"
        log(f"phase 6 rate {key}: {reuse:.1f} snapshots/s (median step, "
            f"table reused){extra}")
    log(f"phase 6 peak device memory during the slice: {peak_gib:.3f} GiB")

    kernels_line = {"kernels": [
        dict(name=r.name, route="cuda", source=r.source, replaces=r.replaces,
             launches=launches[r.name], max_abs_err=errs[r.name],
             ms=timing[("era5", r.name)][0],
             plain_ms=timing[("era5", r.name)][1])
        for r in records]}
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
