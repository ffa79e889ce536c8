"""The ``stage_ms.*`` readers (``xcbench/stage_device.py``) on a canned
trace, a canned span log and canned stage records: the records launched in
the window, tied to the trace's clock through the log, summed a stage and
divided by the steps; None where the program keeps no records, the clocks
cannot be tied, or the window holds another number of records than steps.
Then each step cell traced on the CPU: the ``stage.*`` spans its entry
opens are the cells each ``stage_ms.*`` metric lists."""

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
from xcbench import harness, stage_device  # noqa: E402
from xcontour_tpu_torch.utils import prof  # noqa: E402

from conftest import run_cpu  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
STAGE_METRICS = [m for m in BENCH["per_layer"]
                 if m["name"].startswith("stage_ms.")]
OFF = 5000.0     # a trace time less a log time, us
BIAS = 12.0      # a trace range's end past the log's, us


def X(name, ts, dur, tid=1):
    return dict(ph="X", name=name, cat="user_annotation", ts=ts, dur=dur,
                tid=tid, pid=0)


def logged(name, a, b):
    """A log entry of a span at trace times a..b (us)."""
    return (name, 1, int((a - OFF) * 1e3), int((b - OFF - BIAS) * 1e3))


def record(launch_us, ordinal, stages, outside):
    """A stage record launched at trace time ``launch_us``."""
    return prof.StageRecord("pipeline.keff_lwa_pipeline", "replay", ordinal,
                            int((launch_us - OFF) * 1e3), stages, outside)


# a window 1000-10000 us of three steps, each an entry replaying its
# graph; a shorter warm-up step before the window, logged but not traced
STEPS = [(1000 + 3000 * i, 3000 + 3000 * i + 100 * i) for i in range(3)]
MAIN = []
for a, b in STEPS:
    MAIN += [("pipeline.keff_lwa_pipeline", a + 100, b - 100),
             ("graph.replay", a + 300, b - 200)]
EVENTS = [X("xcbench.window", 1000, 9000)] + \
    [X(n, a, b - a) for n, a, b in MAIN]
LOG = [logged(n, a - 2800, b - 3300) for n, a, b in MAIN[:2]] + \
    [logged(n, a, b) for n, a, b in MAIN]
# the warm-up's record, then one a step: cdf 0.5 + 0.1 i ms, lwa 1.0 ms
# in two parts on the last, 0.25 ms outside
RECORDS = [record(-1700, 1, [("stage.cdf", 0.1, 9.0)], 9.0)] + [
    record(a + 350, 2 + i,
           [("stage.cdf", 0.1, 0.5 + 0.1 * i)]
           + ([("stage.lwa", 1.0, 1.0)] if i < 2 else
              [("stage.lwa", 1.0, 0.4), ("stage.lwa", 2.0, 0.6)]), 0.25)
    for i, (a, _) in enumerate(STEPS)]


@pytest.fixture
def tr():
    return harness.Trace(EVENTS, steps=3, units=48, launches={}, kernels={},
                         work={})


@pytest.fixture
def program(monkeypatch):
    """The program's span log and stage records, as the lists above."""
    state = dict(log=LOG, records=RECORDS)
    monkeypatch.setattr(prof, "spans", lambda: list(state["log"]))
    monkeypatch.setattr(prof, "stage_times",
                        lambda: list(state["records"]))
    return state


def read(name, tr):
    return harness.load_module(REPO / "xcbench" / "layer_metrics"
                               / f"{name}.py").read(tr)


def test_the_window_keeps_its_records_tied_through_the_log(tr, program):
    kept = stage_device.in_window(tr)
    assert [r.ordinal for r in kept] == [2, 3, 4]


@pytest.mark.parametrize("name,want", [
    ("stage_ms.cdf", (0.5 + 0.6 + 0.7) / 3),
    ("stage_ms.lwa", (1.0 + 1.0 + 0.4 + 0.6) / 3),
    ("stage_ms.outside", 0.25),
])
def test_ms_a_step_over_the_window(tr, program, name, want):
    assert read(name, tr) == pytest.approx(want)


def test_a_stage_no_record_opened_reads_none(tr, program, capsys):
    assert read("stage_ms.lengths", tr) is None
    assert "stage.lengths" in capsys.readouterr().err


def test_a_count_other_than_the_steps_reads_none(tr, program, capsys):
    program["records"] = RECORDS[:-1]
    assert read("stage_ms.cdf", tr) is None
    assert "2 records launched in the window of 3 steps" in \
        capsys.readouterr().err
    # two records launched in one step
    program["records"] = RECORDS + [record(STEPS[1][0] + 400, 9, [], 0.1)]
    assert stage_device.in_window(harness.Trace(
        EVENTS, 3, 48, {}, {}, {})) is None


def test_nothing_tied_reads_none(tr, program, capsys):
    program["log"] = []                 # no span pairs with a range
    assert read("stage_ms.cdf", tr) is None
    assert "cannot be tied" in capsys.readouterr().err


def test_a_program_without_stage_records_reads_none(tr, monkeypatch,
                                                    capsys):
    monkeypatch.setattr(prof, "spans", lambda: list(LOG))
    monkeypatch.delattr(prof, "stage_times")
    assert all(read(m["name"], tr) is None for m in STAGE_METRICS)
    # said once for the trace, not once a reader
    assert capsys.readouterr().err.count("keeps no stage records") == 1


def test_the_entries_are_the_pipeline_layers():
    assert len(STAGE_METRICS) == 16
    for m in STAGE_METRICS:
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"]) == ("ms", "lower", "program_span", "pipeline",
                                "snapshots_per_s")
        assert (REPO / "xcbench" / "layer_metrics"
                / f"{m['name']}.py").exists()


# the stage spans the entry opened in the run (its traced steps log them)
OPENED = """
from xcontour_tpu_torch.utils import prof as _prof
_run = harness._run
def _opened(ctx, *args):
    out = _run(ctx, *args)
    out["opened"] = sorted({s[0] for s in _prof.spans()
                            if s[0].startswith("stage.")})
    return out
harness._run = _opened
"""
STEP_CELLS = next(m for m in BENCH["end_to_end"]
                  if m["name"] == "step_ms_p95")["workloads"]


@pytest.mark.parametrize("cell", STEP_CELLS)
def test_each_metric_lists_the_cells_whose_entry_opens_its_stage(tiny,
                                                                 cell):
    out = run_cpu(tiny, cell, trace=1, patch=OPENED)
    opened = {n.split(".", 1)[1] for n in out["opened"]} | {"outside"}
    listed = {m["name"].split(".", 1)[1] for m in STAGE_METRICS
              if cell in m["workloads"]}
    assert listed == opened
