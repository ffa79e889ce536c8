"""The program's stage records placed on a traced window.

While tracing is on, each call of a pipeline entry on the card leaves one
stage record (``xcontour_tpu_torch.utils.prof.stage_times``): the device
ms of each ``stage.*`` span of its body, read from timing events that a
replayed CUDA graph records as nodes, and the body's ms in no stage
(``outside_ms``), with the host's ``time.perf_counter_ns`` stamp where the
body was launched.  :func:`in_window` ties that clock to the trace's as
``program_spans`` does (from the spans that are both trace ranges and
log entries) and keeps the records launched inside ``[tr.t0, tr.t1]``,
one a step; :func:`ms_per_step` sums one stage over them.  Each gives
None, with the reason on standard error, where the program keeps no
records (a program without stage timing), the clocks cannot be tied, or
the window holds another number of records than steps.
"""

from __future__ import annotations

import sys
import weakref

from xcbench import program_spans

_KEPT = weakref.WeakKeyDictionary()   # Trace -> its window's records


def _say(msg: str) -> None:
    print(f"[xcbench] stage records: {msg}", file=sys.stderr, flush=True)


def program_records():
    """The program's stage records, or None where it keeps none."""
    try:
        from xcontour_tpu_torch.utils import prof
    except ImportError:
        return None
    times = getattr(prof, "stage_times", None)
    return None if times is None else times()


def in_window(tr, records=None, log=None):
    """The ``records`` (the program's where None) launched inside the
    trace ``tr``'s window, by launch; None where there are none to tie or
    keep, or not one a step of the window."""
    if records is None:
        records = program_records()
    if records is None:
        _say("the program keeps no stage records")
        return None
    if not records:
        _say("the program made no stage record")
        return None
    if log is None:
        log = program_spans.program_log()
    tied = None if log is None else program_spans.offset(tr.ranges, log)
    if tied is None:
        _say("the records' clock cannot be tied to the trace's")
        return None
    off = tied[0]
    kept = sorted((r for r in records
                   if tr.t0 <= r.launch_ns / 1e3 + off <= tr.t1),
                  key=lambda r: r.launch_ns)
    if len(kept) != tr.steps:
        _say(f"{len(kept)} records launched in the window of {tr.steps} "
             "steps")
        return None
    return kept


def ms_per_step(tr, stage: str):
    """Device ms a step of ``stage.<stage>`` over the window's records
    (``outside``: the entries' bodies in no stage); None where the window
    has no records one a step, or none of them opened the stage."""
    if tr not in _KEPT:
        _KEPT[tr] = in_window(tr)
    kept = _KEPT[tr]
    if kept is None:
        return None
    if stage == "outside":
        return sum(r.outside_ms for r in kept) / tr.steps
    name = f"stage.{stage}"
    ms = [m for r in kept for n, _, m in r.stages if n == name]
    if not ms:
        _say(f"no record in the window opened {name}")
        return None
    return sum(ms) / tr.steps
