"""Profiling and observability helpers.

Counterpart of ``xcontour_tpu/utils/prof.py``.  The reference has no
tracing or profiling at all; this module provides what a diagnostics
pipeline needs:

* :func:`span` -- name a stage.  While tracing is off (no profiler live
  and the log off) a span is one cheap check and enters nothing; while it
  is on, the span is a ``torch.profiler`` range on the profiled thread and
  an entry ``(name, native thread id, start_ns, end_ns)`` of a bounded
  in-process span log on the ``time.perf_counter_ns`` clock, on whatever
  thread it runs (a profiler records only the threads it profiles);
* :func:`logging` -- the span log on without a profiler;
* :func:`spans` -- the span log, the newest :data:`LOG_SIZE` spans;
* :class:`Body` and :class:`Stages` -- a pipeline call's device time by
  stage: while tracing is on, each ``stage.*`` span in the body records
  a pair of timing CUDA events on the body's stream, and the call one
  pair around all of its device work; inside a CUDA graph's capture the
  stages' events are external, so every replay records them again;
* :func:`stage_times` -- the stage records, one a timed eager call or
  replay, the newest :data:`LOG_SIZE`, read from the events without a
  synchronise (:func:`settle`);
* :func:`trace` -- a ``torch.profiler`` run over the CPU, every thread and,
  where there is one, the card, written as a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import List, NamedTuple, Tuple

import torch

LOG_SIZE = 65536
# tracing states a span can be given (see tracing())
OFF, LOG, RANGE = 0, 1, 2

_log: collections.deque = collections.deque(maxlen=LOG_SIZE)
_lock = threading.Lock()
_logging = [0]   # the depth of open logging() blocks
_thread = threading.local()
_profiler_here = torch.autograd._profiler_enabled
_ap = torch.autograd.profiler


def tracing() -> int:
    """What a span opened here now does: :data:`RANGE` (a profiler range
    and a log entry) while a torch profiler is live, on this thread or
    in the process (torch's process-wide flag: a profiler of every thread
    leaves its own thread's state off); :data:`LOG` (a log entry) inside
    :func:`logging`; else :data:`OFF` (nothing)."""
    if _ap._is_profiler_enabled or _profiler_here():
        return RANGE
    return LOG if _logging[0] else OFF


class _Off:
    """The span while tracing is off: enters nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _tid() -> int:
    """This thread's native id, asked of the system once a thread."""
    try:
        return _thread.id
    except AttributeError:
        _thread.id = threading.get_native_id()
        return _thread.id


class _Span:
    """An open span.  Its range comes from ``torch.autograd``'s
    ``_record_function_with_args_enter`` (a ``user_annotation``, as
    ``record_function``'s), which keeps the interpreter lock where
    ``record_function`` lets it go: no other thread runs between the
    range's stamp and the log's."""

    __slots__ = ("name", "_range", "_rf", "_t0")

    def __init__(self, name: str, state: int):
        self.name = name
        self._range = state == RANGE
        self._rf = None

    def __enter__(self):
        if self._range:
            self._rf = torch.autograd._record_function_with_args_enter(
                self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _log.append((self.name, _tid(), self._t0, time.perf_counter_ns()))
        if self._rf is not None:
            torch.autograd._record_function_with_args_exit(self._rf)
        return False


class _StageSpan(_Span):
    """A ``stage.*`` span inside a timed body: the span, and a pair of
    timing events in the body's :class:`Stages`."""

    __slots__ = ("_stages",)

    def __init__(self, name: str, state: int, stages: "Stages"):
        super().__init__(name, state)
        self._stages = stages

    def __enter__(self):
        super().__enter__()
        self._stages.open(self.name)
        return self

    def __exit__(self, *exc):
        self._stages.close()
        return super().__exit__(*exc)


def span(name: str):
    """Context manager: the stage ``name``, doing what :func:`tracing`
    says when it opens; a ``stage.*`` span inside a timed body
    (:class:`Stages`) also records its pair of timing events."""
    state = tracing()
    if not state:
        return _OFF
    stages = getattr(_thread, "stages", None)
    if stages is not None and name.startswith("stage."):
        return _StageSpan(name, state, stages)
    return _Span(name, state)


@contextlib.contextmanager
def logging():
    """The span log on inside the block (nested blocks and threads
    allowed), without a profiler."""
    with _lock:
        _logging[0] += 1
    try:
        yield
    finally:
        with _lock:
            _logging[0] -= 1


def spans() -> List[Tuple[str, int, int, int]]:
    """The logged spans, oldest first by end: ``(name, native thread id,
    start_ns, end_ns)`` on the ``time.perf_counter_ns`` clock (a deque's
    append and its copy are each atomic under the interpreter lock)."""
    return list(_log)


# ------------------------------------------------------- device time by stage
class StageRecord(NamedTuple):
    """A timed call's device time by stage, read from its events.

    entry : the entry's span, ``pipeline.<name>``.
    kind, ordinal : 'replay' or 'eager', and the call's ordinal among the
        graph cache's replays or eager calls.
    launch_ns : ``time.perf_counter_ns`` where the call's first event was
        recorded.
    stages : (name, start ms from the call's first event, device ms less
        the stages nested in it), one a ``stage.*`` span opened, in order.
    outside_ms : the call's device ms in no stage: between the stages,
        and a replay's copy of its input and of its outputs.
    """

    entry: str
    kind: str
    ordinal: int
    launch_ns: int
    stages: List[Tuple[str, float, float]]
    outside_ms: float


_records: collections.deque = collections.deque(maxlen=LOG_SIZE)
# entry -> its calls launched and not read yet (Body); a replay's are read
# before its graph replays again
_pending: dict = {}
_lost = [0]


def _event(external: bool):
    """A timing event; an external one, recorded inside a capture, is a
    node of the graph that each replay records."""
    return torch.cuda.Event(enable_timing=True, external=external)


def _mark(stream, external: bool = False):
    ev = _event(external)
    ev.record(stream)
    return ev


def _current(device):
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


class Stages:
    """Context manager around a body run on a tensor of ``device``: the
    timing events of the ``stage.*`` spans opened inside it, on the
    device's current stream.  ``events`` holds [name, parent index, start,
    end] a span (parent -1 at the top).  ``capturing``: the body is being
    captured into a CUDA graph (the events are external nodes, recorded
    again by each replay).  Entered, it is the thread's open body until it
    exits (an entry called inside another times its own)."""

    __slots__ = ("events", "_stream", "_capturing", "_open", "_outer")

    def __init__(self, device, capturing: bool):
        self.events = []
        self._stream = _current(device)
        self._capturing = capturing
        self._open = [-1]

    def open(self, name: str) -> None:
        self._open.append(len(self.events))
        self.events.append([name, self._open[-2],
                            _mark(self._stream, self._capturing), None])

    def close(self) -> None:
        self.events[self._open.pop()][3] = _mark(self._stream,
                                                 self._capturing)

    def __enter__(self):
        self._outer = getattr(_thread, "stages", None)
        _thread.stages = self
        return self

    def __exit__(self, *exc):
        _thread.stages = self._outer
        return False


class Body:
    """Context manager around one call of the entry ``entry`` (its span's
    name) on a tensor of ``device``: a pair of timing events around all
    of the call's device work on the current stream.  The call says what
    ran with :meth:`took`; on a clean exit the call is kept to be read
    (:func:`settle`)."""

    __slots__ = ("entry", "kind", "ordinal", "stages", "launch_ns",
                 "_stream", "_start", "_end")

    def __init__(self, entry: str, device):
        self.entry = entry
        self.stages = None
        self._stream = _current(device)

    def took(self, kind: str, ordinal: int, stages: Stages) -> None:
        """The call ran as ``kind`` ('replay' or 'eager'), the
        ``ordinal``-th of its kind, its stages timed by ``stages`` (a
        replay's are its graph's)."""
        self.kind, self.ordinal, self.stages = kind, ordinal, stages

    def __enter__(self):
        self.launch_ns = time.perf_counter_ns()
        self._start = _mark(self._stream)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None and self.stages is not None:
            self._end = _mark(self._stream)
            _pending.setdefault(self.entry, []).append(self)
        return False


def _read(body: Body, wait: bool) -> None:
    """The record of a launched call, where its device work has finished
    (or, ``wait``, once it has); else one more lost."""
    if not body._end.query():
        if not wait:
            _lost[0] += 1
            return
        body._end.synchronize()
    t0 = body._start
    ev = body.stages.events
    start = [t0.elapsed_time(e[2]) for e in ev]
    ms = [t0.elapsed_time(e[3]) - a for e, a in zip(ev, start)]
    own = list(ms)
    top = t0.elapsed_time(body._end)
    for e, m in zip(ev, ms):
        if e[1] < 0:
            top -= m
        else:
            own[e[1]] -= m
    _records.append(StageRecord(
        body.entry, body.kind, body.ordinal, body.launch_ns,
        [(e[0], a, m) for e, a, m in zip(ev, start, own)], top))


def settle(entry: str) -> None:
    """Read the records of ``entry``'s calls still pending, before its
    next call (and a replay of its graph) records their events again:
    each whose device work has finished; any other is counted lost
    (:func:`stage_records_lost`), not waited for."""
    for body in _pending.pop(entry, ()):
        _read(body, wait=False)


def stage_times() -> List[StageRecord]:
    """The stage records, oldest first, the newest :data:`LOG_SIZE`; the
    pending ones read first (waiting for their device work to finish)."""
    while _pending:
        for body in _pending.pop(next(iter(_pending))):
            _read(body, wait=True)
    return list(_records)


def stage_records_lost() -> int:
    """The calls whose device work had not finished when their entry was
    called again."""
    return _lost[0]


def _all_threads() -> dict:
    """The profiler's option that records every thread, where the
    installed torch has it."""
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return {}
    return dict(experimental_config=cfg)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block over the CPU (every thread, where the installed
    torch can) and, where there is one, the card; yields the
    ``torch.profiler.profile`` and writes its Chrome trace to
    ``log_dir/trace_<pid>_<ns>.json`` (open in Perfetto or
    chrome://tracing) when the block ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts, **_all_threads()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
