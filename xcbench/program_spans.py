"""The program's span log placed on a traced window's axis.

A span of the program (``xcontour_tpu_torch.utils.prof.span``) opened
while a profiler is live is both a range of the trace, where the profiler
records its thread, and an entry ``(name, native thread id, start_ns,
end_ns)`` of the program's span log on ``time.perf_counter_ns``; on a
thread the profiler does not record (the runner's read thread) it is an
entry of the log alone.  :func:`on_trace` ties the two clocks together
from the spans that are in both, read from the data, and returns the
logged spans asked for on the trace's axis.

The tie: the trace's ranges of one name are paired, in order, with a run
of as many consecutive log entries of that name, a run in which the
pairs' durations differ by the same amount within ``DUR_US`` and their
start offsets lie within ``OFF_US`` of the median, at least
``MIN_PAIRS`` pairs and all but a quarter of them (a thread descheduled
between the profiler's stamp and the log's moves a pair).  A range's
end lies a steady few tens of microseconds past the log's (the
profiler's exit of a range), so ends are placed with that difference
too.  Every name that pairs must agree on one offset within ``OFF_US``;
otherwise, or where nothing pairs, the helper gives None and says why
on standard error.
"""

from __future__ import annotations

import statistics
import sys

DUR_US = 20.0
OFF_US = 50.0
MIN_PAIRS = 3


def _say(msg: str) -> None:
    print(f"[xcbench] program spans: {msg}", file=sys.stderr, flush=True)


def program_log():
    """The program's span log, or None where the program keeps none."""
    try:
        from xcontour_tpu_torch.utils import prof
    except ImportError:
        return None
    spans = getattr(prof, "spans", None)
    return None if spans is None else spans()


def _runs(ranges, entries):
    """Each run of consecutive log ``entries`` (start, end in us) that
    pairs with the trace's ``ranges`` (a, b in us): (start offset, end
    less start offset), each the median over the run's pairs that agree
    with the run's medians, where all but a quarter of them do."""
    m = len(ranges)
    need = max(MIN_PAIRS, m - m // 4)
    for k in range(len(entries) - m + 1):
        pairs = list(zip(ranges, entries[k:k + m]))
        offs = [a - s for (a, _), (s, _) in pairs]
        diff = [(b - a) - (e - s) for (a, b), (s, e) in pairs]
        off, bias = statistics.median(offs), statistics.median(diff)
        good = [(o, d) for o, d in zip(offs, diff)
                if abs(o - off) <= OFF_US and abs(d - bias) <= DUR_US]
        if len(good) >= need:
            yield (statistics.median(o for o, _ in good),
                   statistics.median(d for _, d in good))


def offset(ranges, log):
    """(start offset, end bias) in us tying the log's clock to the
    trace's (a trace time = a log time / 1e3 + offset, plus the bias for
    an end), from the trace's ``ranges`` (name, a, b, tid) and the
    ``log``'s entries; None, with the reason on standard error, where no
    name pairs or the names disagree."""
    traced, logged = {}, {}
    for name, a, b, _ in ranges:
        traced.setdefault(name, []).append((a, b))
    for name, _, s, e in log:
        if name in traced:
            logged.setdefault(name, []).append((s / 1e3, e / 1e3))
    cands = {}
    for name, rs in traced.items():
        rs.sort()
        es = sorted(logged.get(name, []))
        if len(rs) >= MIN_PAIRS and len(es) >= len(rs):
            found = list(_runs(rs, es))
            if found:
                cands[name] = found
    if not cands:
        _say("no name's trace ranges pair with its logged spans")
        return None
    # the offset every pairing name agrees on
    agreed = []
    for off, bias in {c for found in cands.values() for c in found}:
        if all(any(abs(o - off) <= OFF_US for o, _ in found)
               for found in cands.values()):
            agreed.append((off, bias))
    if not agreed:
        _say("the names' offsets disagree: " + ", ".join(
            f"{n} {[round(o) for o, _ in f]}" for n, f in cands.items()))
        return None
    offs = [o for o, _ in agreed]
    if max(offs) - min(offs) > OFF_US:
        _say(f"more than one offset fits every name: {sorted(offs)}")
        return None
    return statistics.median(offs), statistics.median(b for _, b in agreed)


def on_trace(tr, names, log=None):
    """The logged spans named in ``names`` on the trace ``tr``'s axis and
    clipped to its window ``[tr.t0, tr.t1]``: [(name, a_us, b_us, tid)]
    by start; None where the program keeps no log (said on standard
    error) or the clocks cannot be tied (see :func:`offset`)."""
    if log is None:
        log = program_log()
    if log is None:
        _say("the program keeps no span log")
        return None
    tied = offset(tr.ranges, log)
    if tied is None:
        return None
    off, bias = tied
    out = []
    for name, tid, s, e in log:
        if name not in names:
            continue
        a, b = s / 1e3 + off, e / 1e3 + off + bias
        if b > tr.t0 and a < tr.t1:
            out.append((name, max(a, tr.t0), min(b, tr.t1), tid))
    return sorted(out, key=lambda r: r[1])
