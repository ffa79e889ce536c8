"""The ``graph_replay_pct`` reader on a canned trace: the ``graph.replay``
ranges over the outermost ``pipeline.*`` ranges of the window, 100 where
every step replays all through its entry, 0 where none replays (a program
without graphs), None where no entry ran."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
from xcbench import harness  # noqa: E402


def X(name, ts, dur, tid=1):
    return dict(ph="X", name=name, cat="user_annotation", ts=ts, dur=dur,
                tid=tid, pid=0)


# a window 1000-10000 us of three steps, each a pipeline entry of 2000 us
STEPS = [(1000 + 3000 * i, 3000 + 3000 * i) for i in range(3)]
WINDOW = [X("xcbench.window", 1000, 9000)]


def read(events):
    tr = harness.Trace(WINDOW + events, steps=3, units=48, launches={},
                       kernels={}, work={})
    return harness.load_module(REPO / "xcbench" / "layer_metrics"
                               / "graph_replay_pct.py").read(tr)


def test_every_step_replaying_reads_100():
    events = [X("pipeline.keff_lwa_pipeline", a, b - a) for a, b in STEPS]
    events += [X("graph.replay", a, b - a) for a, b in STEPS]
    assert read(events) == pytest.approx(100.0)


def test_replays_over_entries():
    # the first step eager (its stages), the second captures then replays
    # for its last 500 us, the third replays from 200 us in to its end
    events = [X("pipeline.keff_lwa_pipeline", a, b - a) for a, b in STEPS]
    events += [X("stage.cdf", 1100, 500), X("graph.capture", 4000, 1400),
               X("graph.replay", 5500, 500), X("graph.replay", 7200, 1800)]
    assert read(events) == pytest.approx(100.0 * 2300 / 6000)


def test_no_replay_reads_0():
    events = [X("pipeline.keff_lwa_pipeline", a, b - a) for a, b in STEPS]
    events += [X("stage.cdf", a + 100, 500) for a, _ in STEPS]
    assert read(events) == 0.0


def test_no_entry_reads_none():
    assert read([X("stage.cdf", a, 500) for a, _ in STEPS]) is None


def test_ranges_past_the_window_are_clipped():
    events = [X("pipeline.lwa_pipeline", 500, 1500),
              X("graph.replay", 600, 1300),
              X("pipeline.lwa_pipeline", 9000, 2000),
              X("graph.replay", 9500, 1000)]
    assert read(events) == pytest.approx(100.0 * (900 + 500) / (1000 + 1000))
