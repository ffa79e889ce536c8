"""The benchmark's machinery, driven by the files beside it.

Everything one cell, configuration, kernel or per-layer metric needs lives
in a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: a deployment's grid, batch and field;
- ``cells/<cell>.json``: the entry, its arguments, the driver, the
  comparison and its limits;
- ``drivers/<driver>.py``: one way to drive the program;
- ``fields/<maker>.py``: one input maker;
- ``reference/<chain>.py``: one plain reference chain;
- ``kernels/<K>.json``: a kernel's CUDA names, work function and counter;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: one reader
  per metric.

A run sets up one cell, measures it for a fixed time (or, traced, for a
fixed number of steps under ``torch.profiler``), reads the peak memory,
then compares a sample of the answers drawn from the seed with the
reference, and returns the result line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import random
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from xcbench import compare
from xcbench.roofline_work import bound_ms

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names no run may load: JAX and the JAX package (the
# port's name begins with the latter's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "xcontour_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


_LOADED = {}


def load_module(path) -> object:
    """A module loaded from its file, once (file names may hold dots)."""
    path = Path(path).resolve()
    if path not in _LOADED:
        name = "xcbench_file_" + path.stem.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def resolve(ref: str):
    """The attribute ``attr`` of the module ``module`` named ``module:attr``
    (``module`` imported, e.g. ``xcbench.roofline_work`` or a module of
    the program)."""
    mod, attr = ref.split(":")
    m = importlib.import_module(mod)
    for part in attr.split("."):
        m = getattr(m, part)
    return m


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def coords(cfg: dict):
    """(lat, lon) in degrees, ascending, from the configuration's grid."""
    import numpy as np
    g = cfg["grid"]
    lat = g["lat"]
    if lat["kind"] == "linspace":
        y = np.linspace(lat["start"], lat["stop"], lat["num"])
    elif lat["kind"] == "gaussian":
        y = np.rad2deg(np.arcsin(np.polynomial.legendre.leggauss(
            lat["num"])[0]))
    else:
        raise ValueError(f"unknown latitude kind {lat['kind']!r}")
    if g["lon"]["kind"] != "periodic":
        raise ValueError(f"unknown longitude kind {g['lon']['kind']!r}")
    n = g["lon"]["num"]
    return y, np.arange(n) * (360.0 / n)


def context(workload: str, seed: int, device):
    """The run's context: the cell, its configuration, the seed, the
    device and a fresh temporary directory under TMPDIR."""
    import tempfile
    bench = benchmark()
    wl = next((w for w in bench["workloads"] if w["name"] == workload),
              None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = load_json(ROOT / "cells" / f"{workload}.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = load_json(REPO / cfg_entry["file"])
    return SimpleNamespace(
        bench=bench, workload=wl, name=workload, cell=cell, config=cfg,
        seed=int(seed), device=torch.device(device),
        tmp=tempfile.mkdtemp(prefix="xcbench-"),
        driver=load_module(ROOT / "drivers" / f"{cell['driver']}.py"))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------- the window
def measure(ctx, state, seconds: float) -> dict:
    """Steps back to back (each ends in a synchronise) until ``seconds``
    have passed; the window ends with the last step.  ``samples`` answers
    are kept by reservoir sampling from the seed."""
    rng = random.Random(ctx.seed)
    k = int(ctx.cell.get("samples", 3))
    kept, times, units, n = [], [], 0, 0
    counters = {K: c["counter"] for K, c in kernel_specs().items()}
    before = {K: c.launches for K, c in counters.items()}
    t0 = time.perf_counter()
    deadline = t0 + seconds
    te = t0
    while True:
        ts = time.perf_counter()
        if n and ts >= deadline:
            break
        ans, u = ctx.driver.step(state, n, False)
        te = time.perf_counter()
        times.append(te - ts)
        units += u
        keep(kept, k, n, (n, ans), rng)
        n += 1
    return dict(t0=t0, steps=n, units=units, times=times,
                window_s=te - t0, kept=kept,
                launches={K: c.launches - before[K]
                          for K, c in counters.items()})


def keep(kept: list, k: int, n: int, item, rng) -> None:
    """Reservoir sampling: after the n-th item (from 0), ``kept`` holds k
    of the items so far, each as likely as another."""
    if len(kept) < k:
        kept.append(item)
    else:
        j = rng.randrange(n + 1)
        if j < k:
            kept[j] = item


def traced(ctx, state) -> tuple:
    """``trace_steps`` steps under torch.profiler (CPU and CUDA) inside an
    ``xcbench.window`` range, after ``trace_warmup`` steps outside it;
    returns (Trace, window record)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    n_warm = int(ctx.cell.get("trace_warmup", 2))
    n_steps = int(ctx.cell["trace_steps"])
    counters = kernel_specs()
    kept, units = [], 0
    rng = random.Random(ctx.seed)
    k = int(ctx.cell.get("samples", 3))
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n_warm):
            ctx.driver.step(state, i, True)
        before = {K: c["counter"].launches for K, c in counters.items()}
        with torch.profiler.record_function("xcbench.window"):
            for i in range(n_warm, n_warm + n_steps):
                ans, u = ctx.driver.step(state, i, True)
                units += u
                keep(kept, k, i - n_warm, (i, ans), rng)
        after = {K: c["counter"].launches for K, c in counters.items()}
    path = os.path.join(ctx.tmp, "trace.json")
    prof.export_chrome_trace(path)
    events = load_json(path)["traceEvents"]
    os.remove(path)
    work = {}
    for i in range(n_warm, n_warm + n_steps):
        for K, ws in ctx.driver.work(state, i).items():
            work.setdefault(K, []).extend(ws)
    launches = {K: after[K] - before[K] for K in counters}
    tr = Trace(events, n_steps, units, launches, counters, work)
    return tr, dict(steps=n_steps, units=units, kept=kept, launches=launches)


# ------------------------------------------------------------- the trace
def kernel_specs() -> dict:
    """``kernels/<K>.json`` with each counter resolved."""
    out = {}
    for p in sorted((ROOT / "kernels").glob("*.json")):
        spec = load_json(p)
        spec["counter"] = resolve(spec["counter"])
        out[p.stem] = spec
    return out


def kernel_base(name: str) -> str:
    """A CUDA kernel's identifier from the name a trace gives it
    (``void ns::(anonymous namespace)::k<T>(float const*, ...)`` gives
    ``k``)."""
    head = re.split(r"[(<]", name.replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else name


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """A traced window: the device's operations and the host's ranges in
    it, its steps and snapshots, the port kernels' launch counts over it,
    and each kernel's work a launch (from the driver)."""

    def __init__(self, events, steps, units, launches, kernels, work):
        win = [e for e in events if e.get("name") == "xcbench.window"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no xcbench.window range")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.steps, self.units = steps, units
        self.launches, self.kernels, self.work = launches, kernels, work
        self.device, self.ranges = [], []
        ops = {e["args"]["External id"]: e["name"] for e in events
               if e.get("cat") == "cpu_op" and "External id" in
               e.get("args", {})}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b <= self.t0 or a >= self.t1:
                continue
            if e.get("cat") in DEVICE_CATS:
                op = ops.get(e.get("args", {}).get("External id"))
                self.device.append((e["name"], e["cat"], max(a, self.t0),
                                    min(b, self.t1), op))
            elif e.get("cat") == "user_annotation" and \
                    e["name"] != "xcbench.window":
                self.ranges.append((e["name"], a, b, e.get("tid")))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list:
        out = []
        for _, _, a, b, _ in sorted(self.device, key=lambda d: d[2]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_ms(self, names=None, exclude=None) -> float:
        """Device ms of the kernels whose identifier is in ``names`` (all
        kernels if None), or not in ``exclude``."""
        tot = 0.0
        for name, cat, a, b, _ in self.device:
            if cat != "kernel":
                continue
            base = kernel_base(name)
            if names is not None and base not in names:
                continue
            if exclude is not None and base in exclude:
                continue
            tot += b - a
        return tot / 1e3

    def kernel_count(self) -> int:
        return sum(1 for d in self.device if d[1] == "kernel")

    def ranges_named(self, names) -> list:
        return [r for r in self.ranges if r[0] in names]

    def roofline(self, K: str):
        """Percent of K's bound: the bound of every launch in the window
        (the driver's work, one entry a launch) over K's device time; None
        where K did not run, or the launches counted disagree with the
        work."""
        spec = self.kernels.get(K)
        works = self.work.get(K)
        if spec is None or not works:
            return None
        if self.launches.get(K) != len(works):
            log(f"[xcbench] {K}: {self.launches.get(K)} launches counted, "
                f"{len(works)} expected; no roofline")
            return None
        ms = self.kernel_ms(set(spec["names"]))
        if ms <= 0:
            return None
        return 100.0 * sum(bound_ms(w)[0] for w in works) / ms

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (a kernel by the
        operator that launched it and its identifier), and the idle gaps
        summed by the innermost host range open over each."""
        ops = {}
        for name, cat, a, b, op in self.device:
            key = name if cat != "kernel" else \
                f"{op}:{kernel_base(name)}" if op else kernel_base(name)
            ops[key] = ops.get(key, 0.0) + (b - a) / 1e6
        gaps, prev = [], self.t0
        for a, b in self.busy_intervals():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        idle = {}
        for a, b in gaps:
            mid = (a + b) / 2
            open_ = [r for r in self.ranges if r[1] <= mid <= r[2]]
            name = max(open_, key=lambda r: r[1])[0] if open_ else "(none)"
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
        first = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        second = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return dict(device_ops=[list(kv) for kv in first],
                    idle_gaps=[list(kv) for kv in second])


# -------------------------------------------------------------- the device
def device_record(device, peak: int) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=int(peak))
    rec = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
               count=1, memory_peak_bytes=int(peak))
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
        rec["power_limit"] = out.split(",")[-1].strip()
    except (OSError, subprocess.TimeoutExpired):
        rec["power_limit"] = "not read"
    return rec


# --------------------------------------------------------------- the run
def metric_entries(bench: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports: the end-to-end ones that name it (or
    name no cells), or the per-layer ones that do (or that name no cells
    and move an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in mine
                                 else [])]


def within(reading: dict, limits: dict) -> bool:
    """Whether one answer's numbers all lie within their limits (a missing
    or NaN number does not)."""
    return all(reading.get(k, float("nan")) <= v for k, v in limits.items())


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, marks=None) -> dict:
    """One run of one cell; the result line as a dict (``checks`` last).
    ``marks``: the clock's readings where set-up's first phases ended
    (``imports``, ``context``), for its breakdown on standard error."""
    ctx = context(workload, seed, device)
    try:
        return _run(ctx, seconds, trace, t_start, marks or {})
    finally:
        import shutil
        shutil.rmtree(ctx.tmp, ignore_errors=True)


def library_built_now(device) -> bool:
    """Whether this run's set-up will build the program's kernel library
    (a checkout's first run does: nvcc), so that its setup_s is told apart."""
    if device.type != "cuda":
        return False
    from xcontour_tpu_torch.kernels import _build
    return not _build.library_path().exists()


def _run(ctx, seconds, trace, t_start, marks) -> dict:
    dev = ctx.device
    built = library_built_now(dev)
    state = ctx.driver.setup(ctx)
    sync(dev)
    t_first = time.perf_counter()
    if trace:
        tr, win = traced(ctx, state)
    else:
        win = measure(ctx, state, seconds)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"[xcbench] {ctx.name}: {win['steps']} steps, {win['units']} "
        f"snapshots in the window; peak memory {peak} bytes; port kernel "
        "launches a step: " + ", ".join(
            f"{K} {n / win['steps']:g}" for K, n in win["launches"].items()))
    kept = win.pop("kept")
    ctx.driver.release(state)
    samples = ctx.driver.check(state, kept, None)
    limits = ctx.cell["limits"]
    failed = sum(1 for r in samples if not within(r, limits))
    readings = compare.worst(samples)
    checks = {k: dict(value=readings.get(k, float("nan")), limit=v)
              for k, v in limits.items()}
    bad = [k for k, c in checks.items() if not c["value"] <= c["limit"]]
    bench = ctx.bench
    metrics = {}
    for m in metric_entries(bench, ctx.name, trace):
        reader = load_module(ROOT / ("layer_metrics" if trace else
                                     "end_to_end") / f"{m['name']}.py")
        if trace:
            value = reader.read(tr)
        else:
            value = reader.read(dict(win, setup_s=t_first - t_start))
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    record = device_record(dev, peak)
    out = dict(correct=not bad and bool(samples), attempted=win["steps"],
               failed=failed, metrics=metrics, device=record,
               library_built=built)
    phases, t = [], t_start
    for name, at in list(marks.items()) + [("the cell's", t_first)]:
        phases.append(f"{name} {at - t:.3f} s")
        t = at
    log(f"[xcbench] set-up {t_first - t_start:.3f} s ({', '.join(phases)})"
        + (", the kernel library built in it" if built else ""))
    if trace:
        record["busy_s"] = tr.busy_s()
        record["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    for k, c in checks.items():
        log(f"[xcbench] check {k}: {c['value']!r} <= {c['limit']!r}"
            f"{'' if k not in bad else '  FAILED'}")
    out["checks"] = checks
    ctx.driver.close(state)
    return out
