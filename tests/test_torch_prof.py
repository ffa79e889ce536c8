"""The port's profiling helpers (``xcontour_tpu_torch.utils.prof``) on
the CPU: ``annotate`` ranges in a ``torch.profiler`` trace, ``Stopwatch``
records, and ``trace`` writing its Chrome trace."""

import glob
import json
import os

import torch

from xcontour_tpu_torch.utils import prof


def _work(x):
    with prof.annotate("xc.stage"):
        return (x * 2).sum()


def test_annotate_shows_in_a_cpu_trace():
    x = torch.ones(64, 64)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as p:
        _work(x)
    assert "xc.stage" in {e.key for e in p.key_averages()}


def test_stopwatch_records_first_and_per_call():
    sw = prof.Stopwatch()
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return x * scale

    rec = sw.time("mul", fn, torch.ones(8), reps=3, scale=2.0)
    assert len(calls) == 4                       # first call + 3 reps
    assert rec["name"] == "mul" and rec["reps"] == 3
    assert rec["device"] == "cpu"
    assert rec["first_call_s"] >= 0 and rec["per_call_s"] >= 0
    assert sw.records == [rec]
    assert json.loads(sw.report()) == rec


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "tr")
    with prof.trace(log_dir) as p:
        _work(torch.ones(32, 32))
    assert "xc.stage" in {e.key for e in p.key_averages()}
    files = glob.glob(os.path.join(log_dir, "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "xc.stage" for e in events)
