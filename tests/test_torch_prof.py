"""The port's profiling helpers (``xcontour_tpu_torch.utils.prof``) on
the CPU: spans off (nothing entered), on under a profiler (ranges in the
trace, the pipelines' stages nested in their entry) and in the span log
(the runner's read-thread spans, placed on a trace's axis by the
benchmark's ``xcbench/program_spans.py``), and ``trace`` writing a Chrome
trace of every thread."""

import glob
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import xcontour_tpu_torch as xt
from xcontour_tpu_torch.runner import run_batched
from xcontour_tpu_torch.utils import prof
from xcontour_tpu_torch.utils.synth import synth_pv

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from xcbench import harness, program_spans  # noqa: E402

CPU = [torch.profiler.ProfilerActivity.CPU]
WORKER = ("runner.read", "runner.pin")


def _work(x):
    with prof.span("xc.stage"):
        return (x * 2).sum()


def _events(p, tmp_path):
    path = str(tmp_path / f"trace_{time.perf_counter_ns()}.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _ranges(events, prefix=""):
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("tid")) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"
            and e["name"].startswith(prefix)]


def _snapshot(nlat=37, nlon=72):
    d, _ = synth_pv(nlev=3, nlat=nlat, nlon=nlon, seed=3)
    grid = xt.from_latlon(d["latitude"], d["longitude"], device="cpu")
    return torch.as_tensor(d["pv"]), grid


def test_annotate_shows_in_a_cpu_trace():
    x = torch.ones(64, 64)
    with torch.profiler.profile(activities=CPU) as p:
        _work(x)
    assert "xc.stage" in {e.key for e in p.key_averages()}


def _refuse_ranges(monkeypatch):
    def refuse(name, *args):
        raise AssertionError(f"a profiler range {name!r} entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        refuse)


def test_span_off_enters_nothing_and_logs_nothing(monkeypatch):
    _refuse_ranges(monkeypatch)
    assert prof.tracing() == prof.OFF
    t0 = time.perf_counter_ns()
    with prof.span("test.off"):
        pass
    q, grid = _snapshot()
    xt.keff_lwa_pipeline(q, grid, N=9)
    xt.fractal_pipeline(*_snapshot(nlat=32, nlon=64), N=9, strides=(1, 2))
    mine = {"test.off", "pipeline.keff_lwa_pipeline",
            "pipeline.fractal_pipeline", "stage.lwa", "stage.boxcount"}
    assert not [s for s in prof.spans() if s[0] in mine and s[3] >= t0]


def test_logging_logs_without_a_range(monkeypatch):
    _refuse_ranges(monkeypatch)
    with prof.logging():
        assert prof.tracing() == prof.LOG
        with prof.logging():
            with prof.span("test.logged"):
                time.sleep(0.001)
        assert prof.tracing() == prof.LOG
    assert prof.tracing() == prof.OFF
    name, tid, a, b = [s for s in prof.spans() if s[0] == "test.logged"][-1]
    assert tid == threading.get_native_id() and b - a >= 1_000_000


def test_span_log_keeps_every_concurrent_span():
    n_threads, n_spans = 16, 300
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def spin(i):
            for _ in range(n_spans):
                with prof.span(f"test.thread{i}"):
                    pass

        with prof.logging():
            threads = [threading.Thread(target=spin, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            prof.spans()                    # a copy while they append
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    log = prof.spans()
    for i in range(n_threads):
        mine = [s for s in log if s[0] == f"test.thread{i}"]
        assert len(mine) == n_spans and len({s[1] for s in mine}) == 1


@pytest.mark.parametrize("entry,kwargs,stages", [
    ("keff_lwa_pipeline", dict(N=9),
     {"stage.gradient", "stage.table", "stage.contours", "stage.cdf",
      "stage.lookup", "stage.lmin", "stage.keff", "stage.interp",
      "stage.lwa"}),
    # LWA2 under a span of its own, apart from LWA
    ("keff_lwa_pipeline", dict(N=9, with_lwa2=True),
     {"stage.gradient", "stage.table", "stage.contours", "stage.cdf",
      "stage.lookup", "stage.lmin", "stage.keff", "stage.interp",
      "stage.lwa", "stage.lwa2"}),
    ("lwa_pipeline", dict(N=9),
     {"stage.table", "stage.contours", "stage.cdf", "stage.lookup",
      "stage.interp", "stage.lwa", "stage.lwa2"}),
    ("fractal_pipeline", dict(N=9, strides=(1, 2, 4)),
     {"stage.table", "stage.contours", "stage.cdf", "stage.lookup",
      "stage.coarsen", "stage.lengths", "stage.dimension",
      "stage.boxcount"}),
])
def test_pipeline_stages_nest_in_their_entry(tmp_path, entry, kwargs,
                                             stages):
    q, grid = _snapshot(nlat=32, nlon=64)     # strides divide the grid
    with torch.profiler.profile(activities=CPU) as p:
        getattr(xt, entry)(q, grid, **kwargs)
    events = _events(p, tmp_path)
    (outer,) = _ranges(events, "pipeline.")
    assert outer[0] == f"pipeline.{entry}"
    inner = _ranges(events, "stage.")
    assert {r[0] for r in inner} == stages
    assert all(outer[1] <= a and b <= outer[2] and tid == outer[3]
               for _, a, b, tid in inner)
    if entry == "fractal_pipeline":      # once a stride
        assert sum(r[0] == "stage.lengths" for r in inner) == 3


def _run_traced(tmp_path, **profile_kw):
    """run_batched over 12 snapshots in chunks of 2 under a profiler,
    inside an ``xcbench.window`` range: the benchmark's Trace of it, and
    the span log since the run began (runs before it look like it)."""
    snaps = np.random.default_rng(5).normal(size=(12, 24, 48)) \
        .astype(np.float32)

    def step(x):
        return {"mean": x.mean(dim=(-2, -1)), "sq": x * x}

    t0 = time.perf_counter_ns()
    with torch.profiler.profile(activities=CPU, **profile_kw) as p:
        with torch.profiler.record_function("xcbench.window"):
            out = run_batched(step, snaps, batch=2, log=lambda s: None,
                              device="cpu")
    np.testing.assert_allclose(out["mean"], snaps.mean(axis=(1, 2)),
                               rtol=1e-5)
    return (harness.Trace(_events(p, tmp_path), 1, 12, {}, {}, {}),
            [s for s in prof.spans() if s[2] >= t0])


def _placement_errors(tmp_path, cfg):
    """Each read-thread span placed from the log less its range in a
    trace of every thread, the clocks tied from the main thread alone
    (None where they cannot be tied)."""
    tr, log = _run_traced(tmp_path, **cfg)
    truth = sorted((r for r in tr.ranges if r[0] in WORKER),
                   key=lambda r: r[1])
    assert sorted(r[0] for r in truth) == sorted(WORKER * 6)
    main = {r[3] for r in tr.ranges if r[0] == "runner.step"}
    assert len(main) == 1 and not {r[3] for r in truth} & main
    tr.ranges = [r for r in tr.ranges if r[0] not in WORKER]
    placed = program_spans.on_trace(tr, set(WORKER), log=log)
    if placed is None:
        return None
    assert [r[0] for r in placed] == [r[0] for r in truth]
    return [max(abs(a - x), abs(b - y))
            for (_, a, b, _), (_, x, y, _) in zip(placed, truth)]


def test_runner_read_thread_spans_placed_on_an_all_threads_trace(tmp_path):
    cfg = prof._all_threads()
    if not cfg:
        pytest.skip("this torch's profiler cannot record every thread")
    _run_traced(tmp_path, **cfg)   # the profiler's first use of a thread
    # the system may take the CPU from a thread between the profiler's
    # stamp and the log's (100-300 us on a loaded machine): of up to
    # three runs, one ties the clocks and places every span within 50 us
    # of its range
    for _ in range(3):
        errors = _placement_errors(tmp_path, cfg)
        if errors is not None and max(errors) <= 50:
            break
    assert errors is not None and max(errors) <= 50, errors


def test_runner_read_thread_spans_logged_not_traced(tmp_path):
    tr, log = _run_traced(tmp_path)
    assert not [r for r in tr.ranges if r[0] in WORKER]
    assert len([r for r in tr.ranges if r[0] == "runner.wait"]) == 6
    logged = [s for s in log if s[0] in WORKER]
    assert sorted(s[0] for s in logged) == sorted(WORKER * 6)
    assert threading.get_native_id() not in {s[1] for s in logged}
    placed = program_spans.on_trace(tr, set(WORKER), log=log)
    assert len(placed) == 12
    assert all(tr.t0 <= a < b <= tr.t1 for _, a, b, _ in placed)


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "tr")
    with prof.trace(log_dir) as p:
        _work(torch.ones(32, 32))
        with ThreadPoolExecutor(max_workers=1) as pool:
            pool.submit(_work, torch.ones(8, 8)).result()
    assert "xc.stage" in {e.key for e in p.key_averages()}
    files = glob.glob(os.path.join(log_dir, "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    tids = {e.get("tid") for e in events if e.get("name") == "xc.stage"}
    # the main thread's range, and the worker's where torch records it
    assert len(tids) == (2 if prof._all_threads() else 1)
