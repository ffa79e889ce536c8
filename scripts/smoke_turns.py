#!/usr/bin/env python3
"""Run ``chip_smoke.py`` of two checkouts in turns on one card and set their
phase-6 numbers side by side.

    python3 scripts/smoke_turns.py BASE_DIR [NEW_DIR] [--out DIR]

BASE_DIR is the root of another checkout (for example the parent commit,
unpacked with ``git archive``); NEW_DIR defaults to this checkout.  The
script runs BASE, NEW, NEW, BASE, each ``chip_smoke.py`` as its own process
from its own root (each builds its own kernels), keeps each run's output in
DIR (default ``build/smoke_turns``) and prints, for every phase-6 line that
names a time, a bound or a rate, the first number of each run, in run
order.  After each run it also times, in that checkout, K3 and K5
(``lwa_lin``, ``lwa_lin2``) at the LAPE step's shape, 64x100x448, K2
(``weighted_cdf``) at the ERA5 step's input and at this checkout's
``chip_smoke.py`` K2 shapes (the table build, clength's five channels,
uniform noise), and K7 and K8 at this checkout's ``chip_smoke.py``
length cases (ERA5 at N = 121 and 401, the headline Cartesian field, one
ERA5 level in windows of 101 / 10 and ``K8_WINDOWS``), which an older
``chip_smoke.py`` may not time: CUDA events over back-to-back wrapper
calls, and the device time of the kernels from torch.profiler (in all,
and per CUDA kernel); and the geometry steps (ERA5 ``local`` and
``clength`` at N = 121 and 401, the headline ``fractal``): median wall
time and the profiler's device time, with the largest kernels.  K7's
totals at the length cases are kept from every run (``run<i>_k7.pt`` in
DIR) and compared: the script prints whether every run gave the same
bits, base against new.  It exits non-zero if a run fails.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")

# run from a checkout's root; uses only the wrappers of kernels/lwa.py
PROBE = r"""
import numpy as np, torch
from xcontour_tpu_torch.kernels import lwa
B, Ny, Nx = 64, 100, 448
rng = np.random.default_rng(0)
T = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
q = T(-rng.standard_normal((B, Ny, Nx)).cumsum(1) * 0.3)
Q = T(-np.sort(rng.standard_normal((B, Ny)) * 2.0, axis=-1))
W = T(rng.uniform(0.5, 1.5, (Ny, Nx)))
for name in ("lwa_lin", "lwa_lin2"):
    fn = lambda: getattr(lwa, name)(q, Q, W, increase=False)
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(200):
        fn()
    stop.record()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    dev = sum(getattr(e, "self_device_time_total", 0) or 0
              for e in prof.key_averages()
              if not e.key.startswith("aten::")) / 20 / 1e3
    print(f"phase 6 lape {name} wrapper: {start.elapsed_time(stop) / 200:.4f}"
          f" ms a call back to back")
    print(f"phase 6 lape {name} device: {dev:.4f} ms of device kernels a call")
"""


# run from a checkout's root with this checkout's chip_smoke.py as argv[1]:
# its input builders, that checkout's wrappers
PROBE_K2 = r"""
import importlib.util, sys, torch
spec = importlib.util.spec_from_file_location("smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import xcontour_tpu_torch as xt
lat, lon, pv = cs.make_pv(cs.ERA5["B"], cs.ERA5["nlat"], cs.ERA5["nlon"], 0)
grid = xt.from_latlon(lat, lon, device="cuda")
q = torch.as_tensor(pv).to("cuda")
cases = {"weighted_cdf_main":
         cs.kernel_cases(q, grid, cs.ERA5["N"])["weighted_cdf"][0]}
cases.update({k: kern for k, (kern, _, _) in
              cs.k2_cases(q, grid, cs.ERA5["N"]).items()})
for name, kern in cases.items():
    print(f"phase 6 probe {name} wrapper: {cs.cuda_ms(kern, 50):.4f} ms a "
          f"call back to back")
    dev = sum(cs.device_split(kern, 20).values())
    print(f"phase 6 probe {name} device: {dev:.4f} ms of device kernels a "
          f"call")
"""


# run from a checkout's root with this checkout's chip_smoke.py as argv[1]:
# its K7 and K8 inputs, that checkout's wrappers; K7's totals saved to
# argv[2]
PROBE_LENGTH = r"""
import importlib.util, sys, torch
spec = importlib.util.spec_from_file_location("smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import xcontour_tpu_torch as xt
lat, lon, pv = cs.make_pv(cs.ERA5["B"], cs.ERA5["nlat"], cs.ERA5["nlon"], 0)
grid = xt.from_latlon(lat, lon, device="cuda")
q = torch.as_tensor(pv).to("cuda")
_, _, hpv = cs.make_pv(cs.HEADLINE["B"], cs.HEADLINE["nlat"],
                       cs.HEADLINE["nlon"], 100)
hq = torch.as_tensor(hpv).to("cuda")
totals = {}
for name, case in cs.length_cases(q, grid, hq).items():
    kern = case[1]
    if name.startswith("contour_lengths"):
        totals[name] = kern().cpu()
    print(f"phase 6 probe {name} wrapper: {cs.cuda_ms(kern, 50):.4f} ms a "
          f"call back to back")
    split = cs.device_split(kern, 20)
    print(f"phase 6 probe {name} device: {sum(split.values()):.4f} ms of "
          f"device kernels a call")
    for k, ms in split.items():
        print(f"phase 6 probe {name} device {k}: {ms:.4f} ms a call")
torch.save(totals, sys.argv[2])
"""


# run from a checkout's root with this checkout's chip_smoke.py as argv[1]:
# the geometry steps of its phase 4 (ERA5 local_contour_lengths on each of
# 15 levels, clength_pipeline at N = 121 and 401, the headline
# fractal_pipeline), each after a warm-up: the median wall time of 7 steps
# that end in a synchronize, and torch.profiler's device time over 3
# steps, in all and for the 4 largest CUDA kernels
PROBE_STEPS = r"""
import importlib.util, re, statistics, sys, time, torch
spec = importlib.util.spec_from_file_location("smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import xcontour_tpu_torch as xt
lat, lon, pv = cs.make_pv(cs.ERA5["B"], cs.ERA5["nlat"], cs.ERA5["nlon"], 0)
grid = xt.from_latlon(lat, lon, device="cuda")
q = torch.as_tensor(pv).to("cuda")
hlat, hlon, hpv = cs.make_pv(cs.HEADLINE["B"], cs.HEADLINE["nlat"],
                             cs.HEADLINE["nlon"], 100)
hgrid = xt.from_latlon(hlat, hlon, device="cuda")
hq = torch.as_tensor(hpv).to("cuda")
tab = lambda g: xt.cal_area_eqCoord_table_hist(g.fluid_mask(), g.ydef, g.dA,
                                               increase=True, lt=True)
table, htable = tab(grid), tab(hgrid)
steps = {
    "local": lambda: [xt.local_contour_lengths(q[k], grid.ydef, grid.xdef,
                                               **cs.LOCAL)
                      for k in range(q.shape[0])],
    "clength_n121": lambda: xt.clength_pipeline(q, grid, N=121, table=table),
    "clength_n401": lambda: xt.clength_pipeline(q, grid, N=401, table=table),
    "fractal": lambda: xt.fractal_pipeline(hq, hgrid, N=cs.HEADLINE["N"],
                                           strides=cs.FRACTAL_STRIDES,
                                           table=htable),
}
acts = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
for name, fn in steps.items():
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    items = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0) or 0
        if t > 0 and not evt.key.startswith("aten::"):
            m = re.search(r"(\w+)[<(]", evt.key)   # the kernel's own name
            key = (m.group(1) if m else evt.key)[-40:]
            items[key] = items.get(key, 0.0) + t / 3 / 1e3
    wall = statistics.median(walls) * 1e3
    dev = sum(items.values())
    print(f"phase 6 step {name} wall: {wall:.4f} ms (median of 7)")
    print(f"phase 6 step {name} device: {dev:.4f} ms of device kernels")
    for k, ms in sorted(items.items(), key=lambda kv: -kv[1])[:4]:
        print(f"phase 6 step {name} device {k}: {ms:.4f} ms")
"""


def phase6(text: str) -> dict:
    """'phase 6 <key>: <numbers>' -> {key: first number}."""
    found = {}
    for line in text.splitlines():
        if line.startswith("phase 6 ") and ":" in line:
            key, rest = line[len("phase 6 "):].split(":", 1)
            nums = NUMBER.findall(rest)
            if nums:
                found[key] = float(nums[0])
    return found


def main() -> int:
    args = sys.argv[1:]
    out = ROOT / "build" / "smoke_turns"
    if "--out" in args:
        i = args.index("--out")
        out = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    if len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    base = Path(args[0]).resolve()
    new = Path(args[1]).resolve() if len(args) == 2 else ROOT
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, (tag, root) in enumerate((("base", base), ("new", new),
                                     ("new", new), ("base", base))):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                              capture_output=True, text=True)
        (out / f"run{i}_{tag}.log").write_text(proc.stdout + proc.stderr)
        print(f"run {i} {tag}: exit {proc.returncode}", flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:] + proc.stderr[-3000:], file=sys.stderr)
            return 1
        probes = ""
        smoke = [str(ROOT / "chip_smoke.py")]
        k7 = str(out / f"run{i}_k7.pt")
        for kind, code, args in (("lape", PROBE, []),
                                 ("k2", PROBE_K2, smoke),
                                 ("length", PROBE_LENGTH, smoke + [k7]),
                                 ("steps", PROBE_STEPS, smoke)):
            probe = subprocess.run([sys.executable, "-c", code, *args],
                                   cwd=root, capture_output=True, text=True)
            (out / f"run{i}_{tag}_{kind}.log").write_text(probe.stdout +
                                                          probe.stderr)
            if probe.returncode != 0:
                print(probe.stderr[-3000:], file=sys.stderr)
                return 1
            probes += probe.stdout
        runs.append((tag, phase6(proc.stdout + probes)))
    keys = []
    for _, found in runs:
        keys += [k for k in found if k not in keys]
    print("key | " + " | ".join(f"run{i} {tag}" for i, (tag, _) in
                                enumerate(runs)))
    for k in keys:
        print(f"{k} | " + " | ".join(
            "-" if k not in found else f"{found[k]:.4f}" for _, found in runs))
    return k7_bits(out, runs)


def k7_bits(out: Path, runs) -> int:
    """Print whether every run's K7 totals have the same bits as run 0's
    (NaN for NaN); 1 if not."""
    import torch
    totals = [torch.load(out / f"run{i}_k7.pt") for i in range(len(runs))]
    same = True
    for name in totals[0]:
        ref = totals[0][name]
        for i, t in enumerate(totals[1:], 1):
            got = t[name]
            eq = torch.equal(torch.isnan(got), torch.isnan(ref)) \
                and torch.equal(torch.nan_to_num(got).view(torch.int32),
                                torch.nan_to_num(ref).view(torch.int32))
            same = same and eq
            print(f"K7 totals {name}: run{i} {runs[i][0]} against run0 "
                  f"{runs[0][0]}: {'bit for bit' if eq else 'DIFFER'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
