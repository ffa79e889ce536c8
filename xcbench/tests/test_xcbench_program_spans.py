"""The readers of the program's spans on a canned trace and a canned span
log: ``host_ms_per_step`` from the trace's ``pipeline.*`` ranges, and
``read_ms_per_snapshot`` and ``pin_ms_per_snapshot`` from the read
thread's logged spans placed by ``program_spans.on_trace``; None where the
spans are missing or the clocks cannot be tied.  Then a traced run of the
archive on the CPU with the program's log, and one with a program that
keeps none (as the parent of the change that added the log)."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
from xcbench import harness, program_spans  # noqa: E402
from xcontour_tpu_torch.utils import prof  # noqa: E402

from conftest import run_cpu  # noqa: E402

OFF = 5000.0     # a trace time less a log time, us
BIAS = 12.0      # a trace range's end past the log's, us
JITTER = [0.0, 3.0, -2.0, 1.0, -4.0, 2.0]


def X(name, ts, dur, tid=1):
    return dict(ph="X", name=name, cat="user_annotation", ts=ts, dur=dur,
                tid=tid, pid=0)


def logged(name, a, b, tid=1, j=0.0):
    """A log entry of a span at trace times a..b (us)."""
    return (name, tid, int((a - OFF + j) * 1e3),
            int((b - OFF - BIAS + j) * 1e3))


# a window 1000-10000 us of three steps on thread 1, each a pipeline
# entry around two stages, inside the runner's step; the runner's wait
# before each step; and on the read thread (log alone) a read and a pin
# a chunk, the first read begun before the window
STEPS = [(1000 + 3000 * i, 1000 + 3000 * i + 2000 + 100 * i)
         for i in range(3)]
MAIN = []
for i, (a, b) in enumerate(STEPS):
    MAIN += [("runner.wait", a + 10, a + 300), ("runner.step", a + 400, b),
             ("pipeline.keff_pipeline", a + 500, b - 100),
             ("stage.cdf", a + 600, a + 900 + 50 * i),
             ("stage.keff", a + 1000, a + 1100)]
WORKER = [("runner.read", 900, 1900), ("runner.pin", 1900, 2100),
          ("runner.read", 4000, 5000), ("runner.pin", 5000, 5200),
          ("runner.read", 7000, 8000), ("runner.pin", 8000, 8200)]
EVENTS = [X("xcbench.window", 1000, 9000), X("xcbench.step", 1000, 8000)] \
    + [X(n, a, b - a) for n, a, b in MAIN]
# the log: a step before the window (its ranges not in the trace), the
# window's main-thread spans with a few us of jitter, the read thread's
LOG = [logged(n, a - 3000, b - 3000) for n, a, b in MAIN[:5]] \
    + [logged(n, a, b, j=JITTER[i % 6]) for i, (n, a, b) in enumerate(MAIN)] \
    + [logged(n, a, b, tid=2) for n, a, b in WORKER]


@pytest.fixture
def tr():
    return harness.Trace(EVENTS, steps=3, units=48, launches={}, kernels={},
                         work={})


@pytest.fixture
def log(monkeypatch):
    monkeypatch.setattr(prof, "spans", lambda: list(LOG))


def read(name, tr):
    return harness.load_module(REPO / "xcbench" / "layer_metrics"
                               / f"{name}.py").read(tr)


def test_host_ms_per_step_is_the_union_of_pipeline_ranges(tr):
    want = sum(b - a - 600 for a, b in STEPS) / 1e3 / 3
    assert read("host_ms_per_step", tr) == pytest.approx(want)
    # a nested entry adds nothing; a range past the window is clipped
    tr.ranges += [("pipeline.lwa_pipeline", 1600, 1700, 1),
                  ("pipeline.keff_pipeline", 9900, 10500, 1)]
    assert read("host_ms_per_step", tr) == pytest.approx(want + 0.1 / 3)


def test_read_and_pin_from_the_placed_log(tr, log):
    # the first read clipped at the window's start; each end placed with
    # the ranges' common end bias
    assert read("read_ms_per_snapshot", tr) == pytest.approx(
        (900 + 1000 + 1000) / 1e3 / 48, abs=1e-4)
    assert read("pin_ms_per_snapshot", tr) == pytest.approx(
        3 * 200 / 1e3 / 48, abs=1e-4)


def test_on_trace_places_spans_on_the_trace_axis(tr, log):
    off, bias = program_spans.offset(tr.ranges, LOG)
    assert off == pytest.approx(OFF, abs=4) and \
        bias == pytest.approx(BIAS, abs=1)
    placed = program_spans.on_trace(tr, {"runner.pin"})
    want = [(a, b) for n, a, b in WORKER if n == "runner.pin"]
    assert [(n, t) for n, _, _, t in placed] == [("runner.pin", 2)] * 3
    assert [(a, b) for _, a, b, _ in placed] == [
        (pytest.approx(a, abs=4), pytest.approx(b, abs=4)) for a, b in want]


def test_readers_give_nothing_without_the_spans(tr, monkeypatch):
    names = ("read_ms_per_snapshot", "pin_ms_per_snapshot")
    monkeypatch.delattr(prof, "spans")       # a program that keeps no log
    assert [read(n, tr) for n in names] == [None, None]
    # a log without the read thread's spans
    monkeypatch.setattr(prof, "spans", lambda: [s for s in LOG if s[1] == 1],
                        raising=False)
    assert [read(n, tr) for n in names] == [None, None]
    tr.ranges = [r for r in tr.ranges if not r[0].startswith("pipeline.")]
    assert read("host_ms_per_step", tr) is None


def test_no_tie_where_the_offsets_disagree_or_nothing_pairs(tr, capsys):
    # the waits logged 1 ms late: two names, two offsets
    shifted = [(n, t, s + (1_000_000 if n == "runner.wait" else 0),
                e + (1_000_000 if n == "runner.wait" else 0))
               for n, t, s, e in LOG]
    assert program_spans.on_trace(tr, {"runner.read"}, log=shifted) is None
    assert "disagree" in capsys.readouterr().err
    # durations that do not match, every other span 200 us longer: no
    # run of the log pairs
    stretched = [(n, t, s, e + 200_000 * (i % 2))
                 for i, (n, t, s, e) in enumerate(LOG)]
    assert program_spans.on_trace(tr, {"runner.read"}, log=stretched) \
        is None
    assert "pair" in capsys.readouterr().err
    # fewer than three ranges of every name
    tr.ranges = tr.ranges[:10]
    assert program_spans.on_trace(tr, {"runner.read"}, log=LOG) is None


def test_traced_archive_reads_the_read_thread(tiny):
    out = run_cpu(tiny, "era5.archive_keff", trace=1)
    got = out["metrics"]
    assert {"read_ms_per_snapshot", "pin_ms_per_snapshot",
            "cli_io_ms_per_snapshot", "runner_wait_pct"} <= set(got)
    assert all(got[k]["value"] > 0 for k in ("read_ms_per_snapshot",
                                             "pin_ms_per_snapshot"))


def test_traced_runs_of_a_program_without_the_log(tiny):
    patch = ("from xcontour_tpu_torch.utils import prof\n"
             "del prof.spans\n")
    out = run_cpu(tiny, "era5.archive_keff", trace=1, patch=patch)
    assert out["metrics"] and not {"read_ms_per_snapshot",
                                   "pin_ms_per_snapshot"} & set(
        out["metrics"])
