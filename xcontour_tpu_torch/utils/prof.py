"""Profiling and observability helpers.

Counterpart of ``xcontour_tpu/utils/prof.py``.  The reference has no
tracing or profiling at all; this module provides what a diagnostics
pipeline needs:

* :func:`annotate` -- name a stage so that it shows up in a
  ``torch.profiler`` trace (``record_function``);
* :class:`Stopwatch` -- times a callable with its first call and its
  per-call cost kept apart: with CUDA events on the current stream of the
  device its CUDA tensors lie on, with the host clock otherwise;
* :func:`trace` -- a ``torch.profiler`` run over the CPU and, where there
  is one, the card, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch


def annotate(name: str):
    """Context manager: a named range in profiler traces."""
    return torch.profiler.record_function(name)


def _cuda_device(tree) -> Optional[torch.device]:
    """The device of the first CUDA tensor in a nest of lists, tuples and
    dicts, or None."""
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            dev = _cuda_device(leaf)
            if dev is not None:
                return dev
    return None


def _timed(fn: Callable, args, kwargs, reps: int, dev) -> tuple:
    """(seconds per call, last output) over ``reps`` calls: CUDA events on
    ``dev``'s current stream, or the host clock when ``dev`` is None."""
    if dev is None:
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args, **kwargs)
        return (time.perf_counter() - t0) / reps, out
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn(*args, **kwargs)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3 / reps, out


@dataclass
class Stopwatch:
    """First-call and per-call timing of callables (CUDA events on the card,
    the host clock on the CPU)."""

    records: List[Dict[str, Any]] = field(default_factory=list)

    def time(self, name: str, fn: Callable, *args, reps: int = 10,
             **kwargs) -> Dict[str, Any]:
        dev = _cuda_device([args, kwargs])
        first, out = _timed(fn, args, kwargs, 1, dev)
        dev = dev or _cuda_device(out)
        per_call, _ = _timed(fn, args, kwargs, reps, dev)
        rec = dict(name=name, first_call_s=round(first, 6),
                   per_call_s=round(per_call, 6), reps=reps,
                   device=str(dev or "cpu"))
        self.records.append(rec)
        return rec

    def report(self) -> str:
        return "\n".join(json.dumps(r) for r in self.records)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block over the CPU and, where there is one, the card;
    yields the ``torch.profiler.profile`` and writes its Chrome trace to
    ``log_dir/trace_<pid>_<ns>.json`` (open in Perfetto or
    chrome://tracing) when the block ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
