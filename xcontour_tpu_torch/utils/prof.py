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
* :func:`trace` -- a ``torch.profiler`` run over the CPU, every thread and,
  where there is one, the card, written as a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import List, Tuple

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


def span(name: str):
    """Context manager: the stage ``name``, doing what :func:`tracing`
    says when it opens."""
    state = tracing()
    return _Span(name, state) if state else _OFF


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
