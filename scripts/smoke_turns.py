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
order.  After each run it also times K3 and K5 (``lwa_lin``, ``lwa_lin2``)
of that checkout at the LAPE step's shape, 64x100x448, which
``chip_smoke.py`` does not time: CUDA events over back-to-back wrapper
calls, and the device time of the kernels from torch.profiler.  It exits
non-zero if a run fails.
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
        probe = subprocess.run([sys.executable, "-c", PROBE], cwd=root,
                               capture_output=True, text=True)
        (out / f"run{i}_{tag}_lape.log").write_text(probe.stdout +
                                                    probe.stderr)
        if probe.returncode != 0:
            print(probe.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append((tag, phase6(proc.stdout + probe.stdout)))
    keys = []
    for _, found in runs:
        keys += [k for k in found if k not in keys]
    print("key | " + " | ".join(f"run{i} {tag}" for i, (tag, _) in
                                enumerate(runs)))
    for k in keys:
        print(f"{k} | " + " | ".join(
            "-" if k not in found else f"{found[k]:.4f}" for _, found in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
